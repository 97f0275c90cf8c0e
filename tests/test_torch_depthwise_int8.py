"""K4, the depthwise int8 conv (``yolo_tpu_torch/ops/depthwise_int8.py``,
``csrc/depthwise_int8.cu``), and the int8 engine's route to it through
``ops/conv_int8.grouped_conv_int8``.

On the CPU: which convs K4 takes (every grouped conv of the cfgs); the
plain twin ``fused_depthwise_int8_reference`` against the plain grouped
path and against exact float64 sums; the wrapper's input checks; the
kernel's name in the benchmark's trace groups; the build's hash of the
headers; the 15 depthwise shapes of yolov3-mobilenet @640 and their bound.
Tests marked ``gpu`` hold the kernel to its twin on the card, bit for bit,
and count its launches in engine batches; they skip without a card. The
file imports no jax:
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_depthwise_int8.py``.
"""

import glob
import os
import re
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MOBILE_CFG = os.path.join(ROOT, 'cfg', 'yolov3-mobilenet',
                          'yolov3-mobilenet-visdrone.cfg')


def _cases(seed, n, h, w, c, k, spread=2.5):
    """Random int8 codes and weights over the whole int8 range, an f32
    bias, and a pow-2 scale that puts the outputs' std at about 40 quanta
    of 2^-4."""
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randint(-128, 128, (n, h, w, c), generator=g,
                       dtype=torch.int8)
    w8 = torch.randint(-128, 128, (c, k, k, 1), generator=g,
                       dtype=torch.int8)
    bias = torch.randn(c, generator=g) * 0.5
    scale = 2.0 ** round(np.log2(spread / (k * 74.0 ** 2)))
    return x8, w8, bias, scale, 2.0 ** -4


def _meta(n, h, w, c, k):
    return (torch.zeros((n, h, w, c), dtype=torch.int8, device='meta'),
            torch.zeros((c, k, k, 1), dtype=torch.int8, device='meta'))


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize('w_shape,groups,stride,pad,want', [
    ((16, 3, 3, 1), 16, 1, 1, True),
    ((16, 5, 5, 1), 16, 2, 2, True),
    ((16, 3, 3, 1), 16, (1, 2), (0, 1), True),     # split rows, a pair
    ((16, 7, 7, 1), 16, 2, 3, True),
    ((16, 1, 1, 1), 16, 1, 0, True),
    ((16, 3, 3, 2), 8, 1, 1, False),               # two channels a group
    ((16, 3, 3, 1), 8, 1, 1, False),               # groups != C
    ((16, 9, 9, 1), 16, 1, 4, False),              # window beyond 7
    ((16, 4, 4, 1), 16, 1, 2, False),              # even window
    ((16, 3, 5, 1), 16, 1, 1, False),              # not square
    ((16, 3, 3, 1), 16, 3, 1, False),              # stride 3
    ((16, 3, 3, 1), 16, (2, 3), 1, False),
    ((16, 3, 3, 1), 16, 1, -1, False),
])
def test_takes(w_shape, groups, stride, pad, want):
    from yolo_tpu_torch.ops.depthwise_int8 import takes
    x8 = torch.zeros((1, 8, 8, 16), dtype=torch.int8, device='meta')
    w8 = torch.zeros(w_shape, dtype=torch.int8, device='meta')
    assert takes(x8, w8, groups, stride, pad) is want


def _grouped_convs(cfg):
    from yolo_tpu_torch.ir import build_ir
    return [l for l in build_ir(cfg).layers
            if l.kind in ('conv', 'depthwise') and l.groups > 1]


GROUPED_CFGS = sorted(c for c in glob.glob(os.path.join(ROOT, 'cfg', '*',
                                                        '*.cfg'))
                      if _grouped_convs(c))


@pytest.mark.parametrize('cfg', GROUPED_CFGS,
                         ids=[os.path.basename(c) for c in GROUPED_CFGS])
def test_k4_takes_every_grouped_conv_of_the_cfgs(cfg):
    """Every conv of the cfgs that the engine hands ``grouped_conv_int8``
    (mobilenet, mobilenet-small, ghostnet, efficientnetB0) is depthwise,
    3x3 or 5x5, stride 1 or 2, 'same' padding: K4 takes it on the card."""
    from yolo_tpu_torch.ops.depthwise_int8 import takes
    convs = _grouped_convs(cfg)
    for l in convs:
        x8, w8 = _meta(1, 32, 32, l.in_channels, l.size)
        assert l.groups == l.in_channels == l.filters
        assert l.size in (3, 5) and l.pad == l.size // 2
        assert takes(x8, w8, l.groups, l.stride_xy or l.stride, l.pad)
    assert len(GROUPED_CFGS) == 11


def test_grouped_conv_int8_stays_plain_on_the_cpu():
    """On the CPU ``grouped_conv_int8`` runs the plain path for a depthwise
    conv too (K4 is a CUDA kernel): no launch is counted."""
    from yolo_tpu_torch.ops.conv_int8 import grouped_conv_int8
    from yolo_tpu_torch.utils.profiler import counter
    x8, w8, bias, sc, osc = _cases(0, 1, 9, 9, 8, 3)
    n0, k0 = grouped_conv_int8.calls, counter('k4.launches')
    grouped_conv_int8(x8, w8, bias, sc, osc, stride=1, pad=1, groups=8,
                      act='relu6')
    assert grouped_conv_int8.calls == n0 + 1
    assert counter('k4.launches') == k0


# ------------------------------------------------------------ the twin

TWIN_CASES = [(3, 1, 1), (3, 2, 1), (5, 1, 2), (5, 2, 2), (3, 1, (0, 1)),
              (5, 2, (0, 2)), (3, (1, 2), 1), (5, (2, 1), (2, 0)),
              (7, 2, 3), (1, 1, 0)]


@pytest.mark.parametrize('k,stride,pad', TWIN_CASES,
                         ids=[f'{k}x{k}_s{s}_p{p}' for k, s, p in TWIN_CASES])
def test_twin_is_the_plain_grouped_path(k, stride, pad):
    """The wrapper on the CPU runs the twin: the output equals
    ``grouped_conv_int8``'s, and the twin's s32 sums equal a float64
    grouped conv of the same codes (exact below 2^53)."""
    from yolo_tpu_torch.ops.conv_int8 import grouped_conv_int8, grouped_conv_s32
    from yolo_tpu_torch.ops.depthwise_int8 import (
        fused_depthwise_int8, fused_depthwise_int8_reference, out_size)
    c = 24
    x8, w8, bias, sc, osc = _cases(k, 2, 11, 13, c, k)
    kw = dict(stride=stride, pad=pad, act='h_swish')
    got = fused_depthwise_int8(x8, w8, bias, sc, osc, **kw)
    want = grouped_conv_int8(x8, w8, bias, sc, osc, groups=c, **kw)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(got, fused_depthwise_int8_reference(x8, w8, bias, sc,
                                                           osc, **kw))
    assert len(torch.unique(got)) > 40            # the grid is well used
    sy, sx = (stride, stride) if isinstance(stride, int) else stride
    py, px = (pad, pad) if isinstance(pad, int) else pad
    acc = F.conv2d(x8.permute(0, 3, 1, 2).double(),
                   w8.permute(0, 3, 1, 2).double(), stride=(sy, sx),
                   padding=(py, px), groups=c)
    sums = grouped_conv_s32(x8, w8, stride=stride, pad=pad, groups=c)
    assert sums.shape[1:3] == out_size(11, 13, k, stride, pad)
    assert torch.equal(sums, acc.permute(0, 2, 3, 1).to(torch.int32))


def test_wrapper_checks_inputs():
    """What the kernel does not take raises before any launch, on every
    device (meta tensors here, for the checks alone)."""
    from yolo_tpu_torch.ops.depthwise_int8 import _check, fused_depthwise_int8
    x, w = _meta(1, 6, 6, 16, 3)
    b = torch.zeros(16, device='meta')
    ok = dict(stride=1, pad=1, act='relu6', qmin=-128, qmax=127)
    _check(x, w, b, **ok)
    _check(x, w, b, **{**ok, 'stride': (1, 2), 'pad': (0, 1), 'qmin': -127})
    bad = [((x.float(), w, b), {}, 'int8'),
           ((x, w.to(torch.int16), b), {}, 'int8'),
           ((x, w, b.double()), {}, 'float32'),
           ((x[0], w, b), {}, r'\(N, H, W, C\)'),
           ((x, w[..., 0], b), {}, r'\(N, H, W, C\)'),
           ((x, w[:8].contiguous(), b), {}, 'widths'),
           ((x, w, b[:8].contiguous()), {}, 'widths'),
           ((x, torch.zeros((16, 3, 3, 2), dtype=torch.int8, device='meta'),
             b), {}, 'widths'),
           ((x, *_meta(1, 6, 6, 16, 9)[1:], b), {'pad': 4}, 'unsupported'),
           ((x, w, b), {'stride': 3}, 'unsupported'),
           ((x, w, b), {'pad': -1}, 'unsupported'),
           ((x[:, :1, :1].contiguous(), w, b), {'pad': 0}, 'does not fit'),
           ((x, w, b), {'act': 'gelu'}, 'activation'),
           ((x, w, b), {'qmin': -129}, 'int8 range'),
           ((x, w, b), {'qmax': 128}, 'int8 range'),
           ((x, w, b), {'qmin': 5, 'qmax': 4}, 'int8 range'),
           ((x.transpose(1, 2), w, b), {}, 'contiguous'),
           ((x, w, torch.zeros(16)), {}, 'is on')]
    for args, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            _check(*args, **{**ok, **kw})
    with pytest.raises(ValueError, match='no kernel'):
        fused_depthwise_int8(x, w, b, 1.0, 1.0, **ok)
    xc, wc, bc, sc, osc = _cases(0, 1, 6, 6, 16, 3)
    with pytest.raises(ValueError, match='widths'):
        fused_depthwise_int8(xc, wc[:8].contiguous(), bc, sc, osc, **ok)
    with pytest.raises(ValueError, match='int8 range'):
        fused_depthwise_int8(xc, wc, bc, sc, osc, **{**ok, 'qmax': 200})


# ------------------------------------------------- the kernel, from the CPU

def test_kernel_name_falls_in_other():
    """The profiler shows K4 under its demangled name, with its template
    arguments and its parameter's type: the benchmark's trace groups it
    with no library kernel and not with K2 ('other', as K3), so that
    ``k2_roofline`` and the library groups keep their kernels."""
    from benchmark.trace import group_of
    src = open(os.path.join(ROOT, 'yolo_tpu_torch', 'csrc',
                            'depthwise_int8.cu')).read()
    kernels = re.findall(r'__global__ void __launch_bounds__\(\w+\)\s+'
                         r'(\w+)\(const (\w+) ', src)
    assert kernels == [('depthwise_int8_kernel', 'DwArgs')]
    for k in (1, 3, 5, 7):
        for sx in (1, 2):
            for v in (1, 4, 8):
                name = (f'void (anonymous namespace)::depthwise_int8_kernel<'
                        f'{k}, {sx}, {v}>((anonymous namespace)::DwArgs)')
                assert group_of(name) == 'other', name


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """The cached library's name changes with a header the sources
    include, not only with the sources (a stale library is never
    loaded)."""
    from yolo_tpu_torch import _build
    (tmp_path / 'a.cu').write_text('#include "b.cuh"\n')
    (tmp_path / 'b.cuh').write_text('// one\n')
    monkeypatch.setattr(_build, 'CSRC_DIR', tmp_path)
    first = _build.library_path()
    (tmp_path / 'b.cuh').write_text('// two\n')
    assert _build.library_path() != first
    (tmp_path / 'b.cuh').write_text('// one\n')
    assert _build.library_path() == first


def test_k2_and_k4_share_the_epilogue_header():
    """K2 and K4 take the activation codes and ``activate_rare`` from one
    header; no source defines its own."""
    csrc = os.path.join(ROOT, 'yolo_tpu_torch', 'csrc')
    head = open(os.path.join(csrc, 'epilogue_int8.cuh')).read()
    assert 'enum Act' in head and 'activate_rare' in head
    for name in ('conv_int8.cu', 'depthwise_int8.cu'):
        src = open(os.path.join(csrc, name)).read()
        assert '#include "epilogue_int8.cuh"' in src
        assert 'enum Act' not in src and 'float activate_rare(' not in src


def test_mobilenet_640_depthwise_shapes():
    """The 15 depthwise convs of yolov3-mobilenet @640 bs 8, as the smoke
    run times them, are the benchmark's grouped convs: 1.20 G
    multiply-adds, 246.8 MB, a bound of 0.0737 ms."""
    import chip_smoke
    from benchmark import counts
    from benchmark.reference import darknet
    shapes = chip_smoke.depthwise_shapes(MOBILE_CFG, 640)
    layers = darknet.build(open(MOBILE_CFG).read().splitlines())
    convs = darknet.macs(layers, 640)
    calls = counts.grouped_calls(convs, layers)
    assert [(h, c, k, s) for _, h, _, c, k, s, _, _ in shapes] == [
        (c[1], c[0].cin, c[0].size, c[0].stride) for c in calls]
    assert {s[0] for s in shapes} == {8} and len(shapes) == 15
    assert {act for *_, act in shapes} == {'relu6', 'h_swish'}
    assert {c % 8 for _, _, _, c, *_ in shapes} == {0}       # K4's 8-byte pieces
    macs = n_bytes = 0
    for n, h, w, c, k, s, p, _ in shapes:
        ho = (h + 2 * p - k) // s + 1
        macs += n * ho * ho * c * k * k
        n_bytes += n * h * w * c + c * k * k + 4 * c + n * ho * ho * c
    assert macs == 1_201_152_000
    assert n_bytes == 246_793_272
    assert counts.grouped_bound_ms(convs, layers, 8) == pytest.approx(
        n_bytes / counts.HBM_BYTES_PER_S * 1e3)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    yield torch.device('cuda')


# activations whose PyTorch form may round an ulp apart from the
# kernel's (exp, log1p, tanh): there the codes may differ by one quantum
TRANSCENDENTAL = ('mish', 'swish', 'logistic')


def _k4_vs_twin(x8, w8, bias, sc, osc, **kw):
    """K4 through the engine's route (``grouped_conv_int8``) against the
    twin on the same card: bit-equal (at most one quantum apart for the
    transcendental activations); one launch counted."""
    from yolo_tpu_torch.ops.conv_int8 import grouped_conv_int8
    from yolo_tpu_torch.ops.depthwise_int8 import (
        fused_depthwise_int8_reference)
    from yolo_tpu_torch.utils.profiler import counter
    n0 = counter('k4.launches')
    got = grouped_conv_int8(x8, w8, bias, sc, osc, groups=x8.shape[-1], **kw)
    torch.cuda.synchronize()
    assert counter('k4.launches') == n0 + 1
    want = fused_depthwise_int8_reference(x8, w8, bias, sc, osc, **kw)
    assert got.dtype == torch.int8 and got.shape == want.shape
    if kw.get('act') in TRANSCENDENTAL:
        assert int((got.int() - want.int()).abs().max()) <= 1
    else:
        assert torch.equal(got, want)
    return got


@pytest.mark.gpu
def test_k4_matches_twin_on_mobilenet_shapes(cuda):
    """All 15 depthwise convs of yolov3-mobilenet @640 (bs 2 of the
    benchmark's 8), with their own activations, bit-equal."""
    import chip_smoke
    shapes = chip_smoke.depthwise_shapes(MOBILE_CFG, 640, bs=2)
    assert len(shapes) == 15
    for i, (n, h, w, c, k, s, p, act) in enumerate(shapes):
        x8, w8, bias, sc, osc = _cases(i, n, h, w, c, k)
        _k4_vs_twin(x8.to(cuda), w8.to(cuda), bias.to(cuda), sc, osc,
                    stride=s, pad=p, act=act)


# (N, H, W, C, K, stride, pad): widths of 1, 12, 20 and 37 (no multiple of 8:
# a channel a thread), 8, 72 and 184 (8-byte pieces, no multiple of 16), 960;
# sides of 1, 2, 7 and 13 (runs cut short, windows past both edges);
# windows 3, 5, 7 and 1; strides and pads as pairs (the split engine's (0,
# pad) on rows with their halo); more channel groups than a block takes
EDGE_CASES = [(2, 13, 13, 1, 3, 1, 1), (1, 7, 13, 8, 5, 2, 2),
              (2, 13, 7, 72, 3, 2, 1), (1, 2, 2, 184, 5, 1, 2),
              (1, 1, 1, 960, 3, 1, 1), (1, 1, 2, 960, 5, 2, 2),
              (2, 7, 7, 12, 7, 1, 3), (1, 13, 13, 20, 7, 2, 3),
              (2, 9, 13, 16, 3, 1, (0, 1)), (2, 10, 7, 24, 5, 2, (0, 2)),
              (1, 13, 13, 32, 3, (2, 1), 1), (1, 13, 7, 40, 5, (1, 2), 2),
              (1, 7, 7, 8, 1, 2, 0), (1, 9, 9, 37, 3, 1, 1),
              (1, 5, 4, 296, 3, 1, 1), (2, 3, 13, 480, 5, 1, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize('case', EDGE_CASES,
                         ids=['x'.join(map(str, c[:5])) + f'_s{c[5]}_p{c[6]}'
                              for c in EDGE_CASES])
def test_k4_edge_cases(cuda, case):
    n, h, w, c, k, s, p = case
    x8, w8, bias, sc, osc = _cases(c, n, h, w, c, k)
    _k4_vs_twin(x8.to(cuda), w8.to(cuda), bias.to(cuda), sc, osc, stride=s,
                pad=p, act='relu6')


def _activations():
    from yolo_tpu_torch.ops.conv_int8 import ACT_CODES
    return [(a, False) for a in ACT_CODES] + [('leaky', True)]


@pytest.mark.gpu
@pytest.mark.parametrize('act,maxabs', _activations())
def test_k4_every_activation(cuda, act, maxabs):
    """Every activation code, and leaky at maxabsscaler's slope of 0.25,
    on 3x3 s1 and 5x5 s2 convs whose outputs straddle 0 and 6."""
    for k, s in ((3, 1), (5, 2)):
        x8, w8, bias, sc, osc = _cases(k, 2, 13, 13, 72, k, spread=5.0)
        _k4_vs_twin(x8.to(cuda), w8.to(cuda), (bias * 4).to(cuda), sc, osc,
                    stride=s, pad=k // 2, act=act, maxabs=maxabs)


@pytest.mark.gpu
def test_k4_tpsq_range_and_multiplier(cuda):
    """TPSQ's [-127, 127] grid with its requant multiplier (127/128) /
    scale, not a power of two, rounded once to f32; outputs that saturate
    both ends."""
    x8, w8, bias, sc, osc = _cases(7, 2, 13, 13, 64, 3, spread=12.0)
    got = _k4_vs_twin(x8.to(cuda), w8.to(cuda), bias.to(cuda), sc, osc,
                      stride=1, pad=1, act='h_swish', qmin=-127, qmax=127,
                      out_mult=(127 / 128) / osc)
    assert int(got.min()) >= -127 and int(got.max()) == 127


@pytest.mark.gpu
@pytest.mark.parametrize('offset', [1, 4, 8])
def test_k4_input_off_a_16_byte_boundary(cuda, offset):
    """An input that starts 1, 4 or 8 bytes past a 16-byte boundary (a
    view into a larger buffer): 8-byte pieces where the address allows,
    else a channel a thread."""
    x8, w8, bias, sc, osc = _cases(offset, 2, 9, 11, 64, 3)
    buf = torch.zeros(x8.numel() + 16, dtype=torch.int8, device=cuda)
    xv = buf[offset:offset + x8.numel()].view(x8.shape)
    xv.copy_(x8.to(cuda))
    assert xv.data_ptr() % 16 == offset and xv.is_contiguous()
    _k4_vs_twin(xv, w8.to(cuda), bias.to(cuda), sc, osc, stride=2, pad=1,
                act='h_swish')


def _engine(cfg, dev, size, quantized):
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.models import int8_engine
    b = trt.load_model(cfg, device=dev, quantized=quantized, steps=100,
                       generator=torch.Generator().manual_seed(0))
    x = trt.preprocess(images(3, 2, size), device=dev)
    b.apply(x, train=True)
    plan = int8_engine.prepare_int8(b.net, b.params, b.state, b.qstate,
                                    b.qcfg)
    return int8_engine.make_int8_apply(b.net, plan, heads_only=True), plan, x


@pytest.mark.gpu
def test_k4_launches_per_mobilenet_640_batch(cuda, monkeypatch):
    """One engine batch of yolov3-mobilenet @640 launches K4 15 times, once
    a depthwise conv, and its int8 heads equal those of the engine through
    the plain grouped path."""
    from yolo_tpu_torch.ops import depthwise_int8
    from yolo_tpu_torch.utils.profiler import counter, reset
    eng, plan, x = _engine(MOBILE_CFG, cuda, 640, 1)
    with torch.inference_mode():
        reset()
        heads = eng(plan.arrays, x)[0]
        torch.cuda.synchronize()
        assert counter('k4.launches') == 15
        assert counter('grouped.calls') == 15
        monkeypatch.setattr(depthwise_int8, 'takes', lambda *a: False)
        reset()
        plain = eng(plan.arrays, x)[0]
        assert counter('k4.launches') == 0
    assert all(torch.equal(h, p) for h, p in zip(heads, plain))


@pytest.mark.gpu
@pytest.mark.parametrize('model,quantized', [('yolov3', 1), ('yolov4', 3)])
def test_k4_never_launches_on_yolov3_or_yolov4(cuda, model, quantized):
    """yolov3 and yolov4 have no grouped conv: an engine batch launches
    K4 0 times."""
    from yolo_tpu_torch.utils.profiler import counter, reset
    eng, plan, x = _engine(os.path.join(ROOT, 'cfg', model, f'{model}.cfg'),
                           cuda, 64, quantized)
    with torch.inference_mode():
        reset()
        eng(plan.arrays, x)
        torch.cuda.synchronize()
    assert counter('k4.launches') == 0 and counter('grouped.calls') == 0
    assert counter('k2.launches') > 0
