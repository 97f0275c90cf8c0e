"""K3, the fused int8 shortcut (``yolo_tpu_torch/ops/shortcut_int8.py``,
``csrc/shortcut_int8.cu``), and the int8 engine's choice of the shortcuts
that run it.

On the CPU: the plain twin ``fused_shortcut_int8_reference`` equal, element
for element, to a literal copy of the engine's f32 chain; which shortcuts of
a calibrated engine take the wrapper; the wrapper's input checks; the
shortcuts of yolov3 and yolov4 @608 counted from their cfgs. Tests marked
``gpu`` hold the kernel to its twin on the card and skip without one. The
file imports no jax:
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_shortcut_int8.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEAKY_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky')
# the conv before shortcut 4 (layer 3) swapped for a standalone
# [batchnorm]: shortcut 4 adds a float edge; the indices stay as they are
FLOAT_EDGE_CFG = LEAKY_CFG.replace(
    '[convolutional]\nbatch_normalize=1\nfilters=16\nsize=3\nstride=1\n'
    'pad=1\nactivation=leaky\n\n[shortcut]\nfrom=-3\nactivation=linear\n\n'
    '[convolutional]\nbatch_normalize=1\nfilters=8\n',
    '[BatchNorm2d]\n\n[shortcut]\nfrom=-3\nactivation=linear\n\n'
    '[convolutional]\nbatch_normalize=1\nfilters=8\n')
assert FLOAT_EDGE_CFG != LEAKY_CFG

# (sx, sa, in_scale, sc): the edges' scales, the shortcut's input scale and
# its output scale
SCALES = {
    'equal': (2.0 ** -4, 2.0 ** -4, 2.0 ** -4, 2.0 ** -3),
    'edges_differ': (2.0 ** -5, 2.0 ** -2, 2.0 ** -4, 2.0 ** -3),
    # x8 * sx / in_scale = x8 / 2: every odd code lands on a .5 tie, and
    # so does every odd sum on the output grid
    'ties': (2.0 ** -3, 2.0 ** -3, 2.0 ** -2, 2.0 ** -1),
    # the edges reach 8 x 127 input quanta and the sums saturate
    'saturate': (2.0 ** -1, 2.0 ** -1, 2.0 ** -4, 2.0 ** -4),
    'not_pow2': (0.013, 0.021, 0.017, 0.029),
}
WIDTHS = [(16, 16), (24, 8), (8, 24)]


def _chain(x8, sx, a8, sa, in_scale, sc, way, qmin, qmax):
    """The int8 engine's shortcut chain (``shortcut_i8``) as it stood
    before K3, written out."""
    def rha(v):
        return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)
    in_s, inv_in = in_scale, 1.0 / in_scale
    inv_sc = 1.0 / sc
    x = x8.to(torch.float32) * sx
    a = a8.to(torch.float32) * sa
    if way == 2:
        xq = torch.clamp(rha(x * inv_in), qmin, qmax) * in_s
        aq = torch.clamp(rha(a * inv_in), qmin, qmax) * in_s
    else:
        xq = rha(x * inv_in) * in_s
        aq = rha(a * inv_in) * in_s
    nx_, na_ = xq.shape[-1], aq.shape[-1]
    if nx_ == na_:
        s = xq + aq
    elif nx_ > na_:
        s = torch.cat([xq[..., :na_] + aq, xq[..., na_:]], -1)
    else:
        s = xq + aq[..., :nx_]
    x = torch.clamp(rha(s * inv_sc), qmin, qmax) * sc
    q = torch.clamp(rha(x * inv_sc), qmin, qmax)
    return q.to(torch.int8)


def _edges(shape_x, shape_a):
    """int8 edges that hold every code, in seeded orders."""
    g = np.random.default_rng(0)
    out = []
    for shape in (shape_x, shape_a):
        n = int(np.prod(shape))
        v = np.resize(np.arange(-128, 128, dtype=np.int8), n)
        out.append(torch.from_numpy(g.permutation(v).reshape(shape)))
    return out


@pytest.mark.parametrize('scales', list(SCALES), ids=list(SCALES))
@pytest.mark.parametrize('widths', WIDTHS,
                         ids=[f'nx{a}_na{b}' for a, b in WIDTHS])
@pytest.mark.parametrize('way', [1, 2])
def test_k3_twin_matches_engine_chain(way, widths, scales):
    """The twin (and the wrapper on CPU tensors) equal to the chain, element
    for element: both ways, the three width rules, edge scales apart from
    the input scale, ties, saturation, scales that are not powers of 2."""
    from yolo_tpu_torch.ops.shortcut_int8 import (
        fused_shortcut_int8, fused_shortcut_int8_reference)
    nx, na = widths
    x8, a8 = _edges((2, 16, 16, nx), (2, 16, 16, na))
    sx, sa, in_scale, sc = SCALES[scales]
    args = (x8, sx, a8, sa, in_scale, sc)
    kw = dict(way=way, qmin=-128, qmax=127)
    want = _chain(*args, **kw)
    got = fused_shortcut_int8_reference(*args, **kw)
    assert got.dtype == torch.int8 and got.shape == x8.shape
    assert torch.equal(got, want)
    assert torch.equal(fused_shortcut_int8(*args, **kw), want)
    if scales == 'ties':
        assert bool((x8.float() * sx / in_scale % 1 == 0.5).any())
    if scales == 'saturate':
        assert int(got.min()) == -128 and int(got.max()) == 127


def _calibrated_engine(tmp_path, cfg_text, quantized, dev='cpu'):
    """A TOY_CFG variant loaded as scheme ``quantized`` (1 google, 2 TPSQ,
    3 ptq_cos), 2 calibration steps, its plan and a batch."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.models.int8_engine import prepare_int8
    p = tmp_path / 'm.cfg'
    p.write_text(cfg_text)
    b = trt.load_model(str(p), device=dev, quantized=quantized, steps=100,
                       generator=torch.Generator().manual_seed(0))
    x = trt.preprocess(images(3, 2, 64), device=dev)
    for _ in range(2):
        b.apply(x, train=True)
    return b, prepare_int8(b.net, b.params, b.state, b.qstate, b.qcfg), x


# variant: (cfg, scheme, (nx, na) of each shortcut that takes the wrapper)
DISPATCH = {
    # shortcuts 4 (16 + 16) and 8 (32 + 16); shortcut 6 is weighted
    'plain': (LEAKY_CFG, 1, [(16, 16), (32, 16)]),
    # shortcut 4 adds the [batchnorm]'s float edge; 8 adds 4's int8 output
    'float_edge': (FLOAT_EDGE_CFG, 1, [(32, 8)]),
    # TPSQ's shortcuts keep the float chain (no requantization)
    'tpsq': (LEAKY_CFG, 2, []),
}


@pytest.mark.parametrize('variant', list(DISPATCH))
def test_engine_takes_k3_where_it_may(tmp_path, monkeypatch, variant):
    """Which shortcuts of a calibrated engine take the wrapper: a plain one
    (one ``from`` layer, no fusion weights, two int8 edges) does; a weighted
    one, one on a float edge and TPSQ's do not."""
    from yolo_tpu_torch.models import int8_engine
    cfg_text, quantized, want = DISPATCH[variant]
    b, plan, x = _calibrated_engine(tmp_path, cfg_text, quantized)
    real = int8_engine.fused_shortcut_int8
    calls = []

    def record(x8, sx, a8, sa, *args, **kw):
        calls.append((x8.shape[-1], a8.shape[-1]))
        assert x8.dtype == a8.dtype == torch.int8
        return real(x8, sx, a8, sa, *args, **kw)

    monkeypatch.setattr(int8_engine, 'fused_shortcut_int8', record)
    with torch.inference_mode():
        int8_engine.make_int8_apply(b.net, plan, heads_only=True)(
            plan.arrays, x)
    assert calls == want


def test_k3_wrapper_checks_inputs():
    """What the kernel does not take raises before any launch (the checks
    run for a CUDA tensor; here on meta tensors)."""
    from yolo_tpu_torch.ops.shortcut_int8 import _check, fused_shortcut_int8
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device='meta')
    a = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device='meta')
    _check(x, a, 1, -128, 127)
    _check(x, a, 2, -8, 7)
    for args, match in (((x.float(), a, 1, -128, 127), 'int8'),
                        ((x, a.to(torch.int32), 1, -128, 127), 'int8'),
                        ((x[0], a, 1, -128, 127), r'\(N, H, W, C\)'),
                        ((x, a[:, :2].contiguous(), 1, -128, 127), 'match'),
                        ((x, a[..., :0].contiguous(), 1, -128, 127), 'match'),
                        ((x, a, 3, -128, 127), 'way'),
                        ((x, a, 1, -200, 127), 'int8 range'),
                        ((x, a, 1, 5, 4), 'int8 range'),
                        ((x.transpose(1, 2), a, 1, -128, 127), 'contiguous'),
                        ((x, a.transpose(1, 2), 1, -128, 127), 'contiguous'),
                        ((x, torch.zeros((1, 4, 4, 8), dtype=torch.int8), 1,
                          -128, 127), 'is on')):
        with pytest.raises(ValueError, match=match):
            _check(*args)
    with pytest.raises(ValueError, match='no kernel'):
        fused_shortcut_int8(x, 1.0, a, 1.0, 1.0, 1.0, way=1, qmin=-128,
                            qmax=127)


# elements added a batch by the 23 shortcuts at 608 px, bs 8
SHORTCUT_ELEMENTS = {'yolov3': 248_414_208, 'yolov4': 147_865_600}


def _cfg(model):
    return os.path.join(ROOT, 'cfg', model, f'{model}.cfg')


@pytest.mark.parametrize('model', list(SHORTCUT_ELEMENTS))
def test_k3_shortcuts_of_yolov3_and_yolov4(model):
    """Each model's 23 shortcuts add two edges of equal width, a multiple
    of 16 (K3's 16-byte pieces), unweighted, from one layer: K3 reads two
    int8 tensors and writes one, 3 bytes an element (745.2 MB a yolov3
    batch, 443.6 MB a yolov4 one)."""
    import chip_smoke
    from yolo_tpu_torch.ir import build_ir
    shapes = chip_smoke.shortcut_shapes(_cfg(model))
    assert len(shapes) == 23
    assert all(nx == na and nx % 16 == 0 for *_, nx, na in shapes)
    assert sum(n * h * w * nx for n, h, w, nx, _ in shapes) == \
        SHORTCUT_ELEMENTS[model]
    assert all(not l.weighted and len(l.layers) == 1
               for l in build_ir(_cfg(model)).layers if l.kind == 'shortcut')


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    yield torch.device('cuda')


def _k3_vs_twin(x8, sx, a8, sa, in_scale, sc, **kw):
    from yolo_tpu_torch.ops.shortcut_int8 import (
        fused_shortcut_int8, fused_shortcut_int8_reference)
    from yolo_tpu_torch.utils.profiler import counter
    n0 = counter('k3.launches')
    got = fused_shortcut_int8(x8, sx, a8, sa, in_scale, sc, **kw)
    torch.cuda.synchronize()
    assert counter('k3.launches') == n0 + 1
    want = fused_shortcut_int8_reference(x8, sx, a8, sa, in_scale, sc, **kw)
    assert got.dtype == torch.int8 and got.shape == x8.shape
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), fused_shortcut_int8_reference(
        x8.cpu(), sx, a8.cpu(), sa, in_scale, sc, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize('way', [1, 2])
@pytest.mark.parametrize('model', list(SHORTCUT_ELEMENTS))
def test_k3_kernel_matches_twin_on_yolo_shortcuts(cuda, model, way):
    """Every (width, size) of the model's 23 shortcuts at 608 px, bs 8, on
    random codes, bit-equal to the twin (run on the card and on the CPU)."""
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    for shape in sorted(set(chip_smoke.shortcut_shapes(_cfg(model)))):
        n, h, w, nx, na = shape
        x8 = torch.randint(-128, 128, (n, h, w, nx), generator=g,
                           dtype=torch.int8).to(cuda)
        a8 = torch.randint(-128, 128, (n, h, w, na), generator=g,
                           dtype=torch.int8).to(cuda)
        _k3_vs_twin(x8, 2.0 ** -4, a8, 2.0 ** -3, 2.0 ** -3, 2.0 ** -2,
                    way=way, qmin=-128, qmax=127)


def _all_pairs(nx, na, dev):
    """Edges of 65536 pixels in which every channel that both edges have
    holds each code of x against each code of a (shifted by the channel, so
    that a channel read in the wrong place shows)."""
    p = torch.arange(65536).view(1, 256, 256, 1)
    code = lambda v: ((v % 256) - 128).to(torch.int8)
    x8 = code(p // 256 + 7 * torch.arange(nx))
    a8 = code(p % 256 + 13 * torch.arange(na))
    return x8.to(dev), a8.to(dev)


# (nx, na, scales, (qmin, qmax)): widths that are no multiple of 16 (8-,
# 4- and 1-byte pieces), nx > na and nx < na, 4-bit codes, ranges that do
# not hold 0, and scales so far apart that the edges reach 2^37 quanta
EDGE_CASES = [(24, 24, 'equal', (-128, 127)), (40, 40, 'ties', (-128, 127)),
              (112, 112, 'not_pow2', (-128, 127)),
              (24, 8, 'edges_differ', (-128, 127)),
              (8, 24, 'saturate', (-128, 127)),
              (12, 4, 'edges_differ', (-128, 127)),
              (5, 3, 'ties', (-128, 127)), (3, 5, 'not_pow2', (-128, 127)),
              (32, 16, 'equal', (-8, 7)), (16, 16, 'not_pow2', (5, 100)),
              (16, 16, 'ties', (-128, -3)), (16, 16, 'far', (-128, 127)),
              (24, 8, 'far', (-128, 127))]
EDGE_SCALES = {**SCALES, 'far': (2.0 ** 20, 2.0 ** 6, 2.0 ** -10, 2.0 ** -12)}


@pytest.mark.gpu
@pytest.mark.parametrize('way', [1, 2])
@pytest.mark.parametrize('case', EDGE_CASES,
                         ids=[f'nx{c[0]}_na{c[1]}_{c[2]}_q{c[3][1]}'
                              for c in EDGE_CASES])
def test_k3_kernel_matches_twin_edge_cases(cuda, case, way):
    """Every pair of codes under each case, bit-equal to the twin; then the
    same edges one byte off a 16-byte boundary (1-byte pieces)."""
    nx, na, scales, (qmin, qmax) = case
    sx, sa, in_scale, sc = EDGE_SCALES[scales]
    kw = dict(way=way, qmin=qmin, qmax=qmax)
    x8, a8 = _all_pairs(nx, na, cuda)
    _k3_vs_twin(x8, sx, a8, sa, in_scale, sc, **kw)
    xo = torch.empty(x8.numel() + 1, dtype=torch.int8, device=cuda)[1:]
    xo = xo.view(x8.shape).copy_(x8)
    assert xo.data_ptr() % 2 == 1 and xo.is_contiguous()
    _k3_vs_twin(xo, sx, a8, sa, in_scale, sc, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize('model,quantized', [('yolov3', 1), ('yolov4', 3)])
def test_k3_launches_per_batch(cuda, monkeypatch, model, quantized):
    """One engine batch of the model (google yolov3, cos-PTQ yolov4, at 64
    px) launches K3 23 times, once a shortcut, and its int8 heads equal
    those of the engine through the twin."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.models import int8_engine
    from yolo_tpu_torch.ops.shortcut_int8 import fused_shortcut_int8_reference
    from yolo_tpu_torch.utils.profiler import counter, reset
    b = trt.load_model(_cfg(model), device=cuda, quantized=quantized,
                       steps=100, generator=torch.Generator().manual_seed(0))
    x = trt.preprocess(images(3, 2, 64), device=cuda)
    b.apply(x, train=True)
    plan = int8_engine.prepare_int8(b.net, b.params, b.state, b.qstate,
                                    b.qcfg)
    eng = int8_engine.make_int8_apply(b.net, plan, heads_only=True)
    with torch.inference_mode():
        reset()
        heads = eng(plan.arrays, x)[0]
        torch.cuda.synchronize()
        assert counter('k3.launches') == 23
        monkeypatch.setattr(int8_engine, 'fused_shortcut_int8',
                            fused_shortcut_int8_reference)
        plain = eng(plan.arrays, x)[0]
    assert all(torch.equal(h, p) for h, p in zip(heads, plain))
