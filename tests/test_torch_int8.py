"""True-int8 serving of the port (yolo_tpu_torch: K2 ``ops/conv_int8.py``,
``models/int8_engine.py``, the sparse NMS on int8 heads, ``runtime``)
against the JAX package, on the CPU.

K2's plain version is held to ``yolo_tpu.ops.pallas_conv.fused_conv_int8``
in interpret mode; the engine to the JAX engine's bit-faithful
``backend='xla'``, jitted as the JAX package runs it, on a plan prepared
by both packages from one JAX-calibrated qstate. Inputs are image batches
/ 256 made from numpy seeds: on that grid the float stem conv is exact in
f32 on both sides, so every int8 tensor can be compared bit for bit.

Tests marked ``gpu`` hold the K2 kernel against its plain version on the
card and skip without one; they need no jax:
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_int8.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# TOY_CFG with its one mish conv (layer 3) made leaky: leaky/linear only
LEAKY_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky')
assert LEAKY_CFG != TOY_CFG

# (N, H, W, Cin, Cout, K, stride, act, out_q), tests/test_pallas_conv.py's
# CASES, which JAX's Pallas kernel is tested on
CASES = [
    (2, 16, 16, 32, 64, 3, 1, 'leaky', True),
    (2, 16, 16, 32, 64, 3, 2, 'leaky', True),
    (2, 19, 19, 64, 255, 1, 1, 'linear', False),
    (1, 13, 13, 128, 256, 3, 2, 'leaky', True),
    (2, 8, 8, 16, 48, 1, 1, 'relu', True),
    (1, 38, 38, 96, 160, 3, 1, 'mish', True),
]
CASE_IDS = [f'{c[5]}x{c[5]}s{c[6]}_{c[3]}to{c[4]}_{c[7]}' for c in CASES]


@pytest.fixture(scope='module', autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def jax_highest():
    import jax
    old = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield jax
    jax.config.update('jax_default_matmul_precision', old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _conv_case(case, seed=0):
    """int8 x (NHWC), w (HWIO, the JAX layout) and f32 bias from a seed."""
    n, h, w, ci, co, k = case[:6]
    rng = np.random.RandomState(seed)
    x8 = rng.randint(-128, 128, (n, h, w, ci)).astype(np.int8)
    w8 = rng.randint(-40, 41, (k, k, ci, co)).astype(np.int8)
    bias = rng.randn(co).astype(np.float32)
    return x8, w8, bias


def _ohwi(w8_hwio):
    return torch.from_numpy(np.ascontiguousarray(w8_hwio.transpose(3, 0, 1, 2)))


# ------------------------------------------------------------- K2 on the CPU

@pytest.mark.parametrize('case', CASES, ids=CASE_IDS)
def test_k2_plain_matches_pallas_interpret(case):
    """int8 outputs array_equal; f32 outputs within atol 1e-3 (the Pallas
    test's own bound)."""
    import jax.numpy as jnp
    from yolo_tpu.ops.pallas_conv import fused_conv_int8 as jconv
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    n, h, w, ci, co, k, s, act, out_q = case
    x8, w8, bias = _conv_case(case)
    scale, oscale = np.float32(2 ** -9), np.float32(2 ** -4)
    want = np.asarray(jconv(jnp.asarray(x8), jnp.asarray(w8),
                            jnp.asarray(bias), scale, oscale, stride=s,
                            act=act, out_q=out_q, interpret=True))
    n0 = fused_conv_int8.launches
    got = fused_conv_int8(torch.from_numpy(x8), _ohwi(w8),
                          torch.from_numpy(bias), scale, oscale, stride=s,
                          act=act, out_q=out_q).numpy()
    assert fused_conv_int8.launches == n0      # the CPU runs the plain twin
    assert got.shape == want.shape
    if out_q:
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_k2_plain_odd_widths_grid_and_maxabs():
    """Cin not a multiple of 4, Cout 255, odd H/W, a narrower output grid
    (qmin/qmax) and the maxabsscaler leaky slope (0.25), against an exact
    int64 numpy conv with the same epilogue."""
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    case = (2, 11, 13, 6, 255, 3)
    x8, w8, bias = _conv_case(case, seed=5)
    for stride, qmin, qmax, maxabs in ((1, -127, 127, True),
                                       (2, -8, 7, False)):
        got = fused_conv_int8(torch.from_numpy(x8), _ohwi(w8),
                              torch.from_numpy(bias), 2.0 ** -9, 2.0 ** -2,
                              stride=stride, act='leaky', maxabs=maxabs,
                              qmin=qmin, qmax=qmax).numpy()
        xp = np.pad(x8.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
        ho, wo = got.shape[1:3]
        acc = np.zeros((2, ho, wo, 255), np.int64)
        for ky in range(3):
            for kx in range(3):
                win = xp[:, ky:ky + stride * ho:stride, kx:kx + stride * wo:stride]
                acc += win @ w8[ky, kx].astype(np.int64)
        y = acc.astype(np.float32) * np.float32(2 ** -9) + bias
        y = np.where(y > 0, y, y * np.float32(0.25 if maxabs else 0.1))
        v = y * np.float32(4.0)
        want = np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), qmin, qmax)
        np.testing.assert_array_equal(got, want.astype(np.int8))
        assert got.min() >= qmin and got.max() <= qmax


def _plan_cases():
    """(id, (M, Cin, Cout, K, out_q)) for each distinct int8 conv shape of
    yolov3 @608 at bs=8 (with its count among the 74) and each conv of
    chip_smoke.py's K2_CASES."""
    import collections
    import chip_smoke
    out = []
    for (n, h, w, ci, co, k, s), times in collections.Counter(
            chip_smoke.int8_conv_shapes()).items():
        ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        out.append((f'yolov3_{h}px_{k}x{k}s{s}_{ci}to{co}_x{times}',
                    (n * ho * wo, ci, co, k, True)))
    for n, h, w, ci, co, k, s, act, out_q, _ in chip_smoke.K2_CASES:
        ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        out.append((f'case_{n}x{h}x{w}_{k}x{k}s{s}_{ci}to{co}_{act}_'
                    f'{"int8" if out_q else "f32"}',
                    (n * ho * wo, ci, co, k, out_q)))
    return out


PLAN_CASES = _plan_cases()
# the N of wgmma.mma_async.m64nNk32.s32.s8.s8 (PTX ISA): 8, 16, 24, then
# multiples of 16 up to 256
WGMMA_S8_WIDTHS = (8, 16, 24) + tuple(range(32, 257, 16))


def test_k2_plan_covers_all_74_yolov3_convs():
    import chip_smoke
    shapes = chip_smoke.int8_conv_shapes()
    assert len(shapes) == 74
    assert sum(int(i.rsplit('_x', 1)[1]) for i, _ in PLAN_CASES
               if i.startswith('yolov3')) == 74


@pytest.mark.parametrize('shape', [c for _, c in PLAN_CASES],
                         ids=[i for i, _ in PLAN_CASES])
def test_k2_tile_plan_is_legal(shape):
    """The host-side tile plan for the kernel: N a legal wgmma width, K
    chunks a multiple of 32 bytes (the k of one s8 wgmma), shared memory
    within the H100's 227 KB and holding the ring, the epilogue's slab, a
    tile's run of output bytes where the kernel builds one, and the
    barriers, at least 2 stages, and a grid that covers every pixel and
    every output channel exactly once."""
    from yolo_tpu_torch.ops import conv_int8 as K
    m, cin, cout, k, out_q = shape
    plan = K.tile_plan(m, cin, cout, k, out_q)
    assert plan.bn in WGMMA_S8_WIDTHS and plan.bn in K.BN_CHOICES
    assert K.BK % 32 == 0
    assert plan.ktot == k * k * (-(-cin // K.CIN_GRANULE) * K.CIN_GRANULE)
    assert plan.ktot % K.CIN_GRANULE == 0 and K.CIN_GRANULE % 16 == 0
    assert 2 <= plan.stages <= 8
    run = K.run_tile(cout, plan.bn, out_q)
    assert plan.rows == run
    assert plan.smem == K.smem_bytes(plan.bn, plan.stages, run)
    assert plan.smem <= K.SMEM_LIMIT == 227 * 1024
    ring = plan.stages * (K.BM + plan.bn) * K.BK
    run_bytes = K.BM * cout + 15 if run else 0   # the run at any 16-byte phase
    slab = K.BM * 32 * 4                    # the s32 sums of 32 channels
    assert plan.smem >= 1024 + ring + slab + run_bytes + 16 * plan.stages
    gx, gy = plan.grid
    assert (gx - 1) * K.BM < m <= gx * K.BM
    assert (gy - 1) * plan.bn < cout <= gy * plan.bn
    assert gy <= 65535


def _kernel_smem_bytes():
    """``smem_bytes(bn, stages, rows)`` of ``csrc/conv_int8.cu`` as Python,
    read from the source: its namespace constants and the two constexpr
    functions that count a block's shared memory."""
    import re
    with open(os.path.join(ROOT, 'yolo_tpu_torch', 'csrc',
                           'conv_int8.cu')) as f:
        src = f.read()
    env = {}
    for name, expr in re.findall(r'^constexpr int (k\w+) = ([^;]+);', src,
                                 re.M):
        env[name] = eval(expr, {}, env)

    def body(fn):
        m = re.search(r'constexpr int ' + fn + r'\(([^)]*)\) \{\s*return '
                      r'(.+?);\s*\}', src, re.S)
        params = [a.split()[-1] for a in m.group(1).split(',')]
        expr = re.sub(r'(\w+) \? (.+) : (.+)', r'(\2 if \1 else \3)',
                      ' '.join(m.group(2).split()))
        return eval(f'lambda {", ".join(params)}: {expr}', env)

    env['rows_bytes'] = body('rows_bytes')
    return env, body('smem_bytes'), src


def test_k2_smem_formula_matches_kernel_source():
    """The plan's shared-memory count (``smem_bytes``) and tile constants
    against the kernel source's, for every BN, ring depth and run of bytes
    the kernel takes: the plan keeps each block within what the kernel
    asks for, and the kernel refuses a plan above the same limit."""
    from yolo_tpu_torch.ops import conv_int8 as K
    env, kernel_smem, src = _kernel_smem_bytes()
    assert (K.BM, K.BK) == (env['kBM'], env['kBK'])
    assert K.SMEM_LIMIT == env['kSmemLimit']
    assert 'smem_bytes(bn, stages, rows) > kSmemLimit' in src
    for bn in K.BN_CHOICES:
        for stages in range(2, 9):
            for rows in (False, True):
                assert K.smem_bytes(bn, stages, rows) == kernel_smem(
                    bn, stages, rows), (bn, stages, rows)


@pytest.mark.parametrize('cin', [6, 16])
@pytest.mark.parametrize('stride', [1, 2])
def test_k2_cin_padding_leaves_twin_unchanged(cin, stride):
    """The wrapper's Cin rule: zero-pad to a multiple of 16 channels only
    where Cin is not one; the plain version on the padded tensors equals
    it on the originals, int8 and f32 outputs."""
    from yolo_tpu_torch.ops.conv_int8 import (CIN_GRANULE,
                                              fused_conv_int8_reference,
                                              pad_cin)
    x8, w8, bias = _conv_case((2, 11, 13, cin, 40, 3), seed=cin + stride)
    x8, w8, bias = torch.from_numpy(x8), _ohwi(w8), torch.from_numpy(bias)
    xp, wp = pad_cin(x8, w8)
    assert xp.shape[-1] == wp.shape[-1] == -(-cin // CIN_GRANULE) * CIN_GRANULE
    if cin % CIN_GRANULE == 0:
        assert xp is x8 and wp is w8
    else:
        assert torch.equal(xp[..., :cin], x8) and not xp[..., cin:].any()
        assert torch.equal(wp[..., :cin], w8) and not wp[..., cin:].any()
    for out_q in (True, False):
        kw = dict(stride=stride, act='leaky', out_q=out_q)
        a = fused_conv_int8_reference(x8, w8, bias, 2.0 ** -9, 2.0 ** -2, **kw)
        b = fused_conv_int8_reference(xp, wp, bias, 2.0 ** -9, 2.0 ** -2, **kw)
        assert torch.equal(a, b)


def test_k2_supported_truth_table():
    from yolo_tpu.ops.pallas_conv import supported as jsupported
    from yolo_tpu_torch.ops.conv_int8 import supported
    for k in (1, 2, 3, 5):
        for stride in (1, 2, 3):
            for pad in (0, 1, 2):
                for groups in (1, 2, 32):
                    assert (supported(k, stride, pad, groups)
                            == jsupported(k, stride, pad, groups))
    assert supported(3, 2, 1, 1) and not supported(1, 2, 0, 1)


def test_k2_wrapper_checks_inputs():
    """What the kernel does not take raises before any launch (the checks
    run for a CUDA tensor; on this machine they are called directly)."""
    from yolo_tpu_torch.ops.conv_int8 import _check
    x = torch.zeros((1, 8, 8, 16), dtype=torch.int8)
    w = torch.zeros((32, 3, 3, 16), dtype=torch.int8)
    b = torch.zeros(32)
    _check(x, w, b, 1, 'leaky', -128, 127)
    for args, match in (((x.float(), w, b, 1, 'leaky', -128, 127), 'int8'),
                        ((x, w, b.double(), 1, 'leaky', -128, 127), 'float32'),
                        ((x, w[:, :, :, :8].contiguous(), b, 1, 'leaky', -128, 127),
                         'match'),
                        ((x, w, b, 3, 'leaky', -128, 127), 'unsupported'),
                        ((x, w, b, 1, 'gelu', -128, 127), 'activation'),
                        ((x, w, b, 1, 'leaky', -200, 127), 'int8 range'),
                        ((x.transpose(1, 2), w, b, 1, 'leaky', -128, 127),
                         'contiguous')):
        with pytest.raises(ValueError, match=match):
            _check(*args)
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    with pytest.raises(ValueError, match='no kernel'):
        fused_conv_int8(x.to('meta'), w.to('meta'), b.to('meta'), 1.0, 1.0,
                        stride=1)


# ------------------------------------------------ engine against JAX's engine

def _write(tmp_path_factory, name, text):
    p = tmp_path_factory.mktemp('i8cfg') / name
    p.write_text(text)
    return str(p)


def _jax_calibrated(cfg_path, steps=3, way=1):
    """JAX build, random weights (numpy seed) and 3 google calibration
    steps on an image batch / 256, as tests/test_int8_engine.py does."""
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    net = build_ir(cfg_path)
    params, state = random_jax_weights(net, seed=0, conv_scale=1.0)
    cfg = JQ.QuantConfig(scheme='google', steps=100, shortcut_way=way)
    qstate = JQ.init_quant_state(net, cfg)[0]
    apply_q = JQ.make_quant_apply(net, cfg, compute_dtype=None)
    x = images(2, 2, 64).astype(np.float32) / 256.0
    st, qs = state, qstate
    for _ in range(steps):
        _, st, qs = apply_q(params, st, qs, jnp.asarray(x), train=True)
    return net, cfg, params, st, qs, x


@pytest.fixture(scope='module')
def calibrated(tmp_path_factory):
    """{name: (cfg path, JAX net, cfg, params, state, qstate, x)} for the
    toy (with mish) and its leaky-only variant."""
    import jax
    old = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    try:
        out = {}
        for name, text in (('toy', TOY_CFG), ('leaky', LEAKY_CFG)):
            path = _write(tmp_path_factory, f'{name}.cfg', text)
            out[name] = (path, *_jax_calibrated(path))
    finally:
        jax.config.update('jax_default_matmul_precision', old)
    return out


def _port_plan(path, params, state, qstate):
    from yolo_tpu_torch.compress.quant import QuantConfig
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.int8_engine import prepare_int8
    net = build_ir(path)
    pt, st = from_jax(net, params, state)
    plan = prepare_int8(net, pt, st, qstate_from_jax(qstate),
                        QuantConfig(steps=100), device='cpu')
    return net, plan


@pytest.mark.parametrize('name', ['toy', 'leaky'])
def test_prepare_int8_matches_jax(calibrated, name):
    """w8 equal element for element (HWIO there, (Cout, K, K, Cin) here),
    the dequantized bias exact, every meta scale equal."""
    from yolo_tpu.models.int8_engine import prepare_int8 as jprepare
    path, jnet, cfg, params, state, qstate, _ = calibrated[name]
    jplan = jprepare(jnet, params, state, qstate, cfg)
    _, plan = _port_plan(path, params, state, qstate)
    n_conv = 0
    for k, v in jplan.arrays.items():
        if 'w8' in v:
            got = plan.arrays[k]['w8']
            assert got.dtype == torch.int8 and got.is_contiguous()
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(v['w8']).transpose(3, 0, 1, 2))
            np.testing.assert_array_equal(plan.arrays[k]['bias'].numpy(),
                                          np.asarray(v['bias']))
            n_conv += 1
    assert n_conv == 11
    assert plan.meta == jplan.meta
    assert (plan.a_bits, plan.shortcut_way, plan.scheme) == (8, 1, 'google')


@pytest.mark.parametrize('name', ['leaky', 'toy'])
def test_engine_matches_jax_xla_engine(calibrated, name):
    """heads_only: the int8 heads bit-equal for the leaky/linear cfg (exact
    integer convs, the same f32 epilogue operations). Where mish runs (the
    toy's layer 3) the two frameworks' tanh/softplus differ by ulps, which
    can flip one LSB at a requant boundary and carry it down: there at most
    1% of head values differ, by at most 2 LSB. Dense io: rtol/atol 1e-4
    where the heads are equal (sigmoid/exp of the decode differ by ulps),
    else the bounds of tests/test_int8_engine.py's _assert_close."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.models.int8_engine import make_int8_apply as jmake
    from yolo_tpu.models.int8_engine import prepare_int8 as jprepare
    from yolo_tpu_torch.models.int8_engine import make_int8_apply
    path, jnet, cfg, params, state, qstate, x = calibrated[name]
    jplan = jprepare(jnet, params, state, qstate, cfg)
    net, plan = _port_plan(path, params, state, qstate)
    jheads = jmake(jnet, jplan, backend='xla', heads_only=True)
    heads = make_int8_apply(net, plan, heads_only=True)
    assert heads.head_scales == jheads.head_scales
    hj, oj = jax.jit(jheads)(jplan.arrays, jnp.asarray(x))
    ht, ot = heads(plan.arrays, torch.from_numpy(x))
    for a, b, oa, ob in zip(hj, ht, oj, ot):
        a, b = np.asarray(a), b.numpy()
        assert b.dtype == np.int8 and a.shape == b.shape
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        if name == 'leaky':
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(ob.numpy(), np.asarray(oa))
        else:
            assert (d > 0).mean() <= 0.01 and d.max() <= 2, (
                (d > 0).sum(), d.max())
    io_j = np.asarray(jax.jit(jmake(jnet, jplan, backend='xla'))(
        jplan.arrays, jnp.asarray(x))[0])
    io_t, yolo_p = make_int8_apply(net, plan)(plan.arrays, torch.from_numpy(x))
    io_t = io_t.numpy()
    assert io_t.shape == io_j.shape and np.isfinite(io_t).all()
    assert len(yolo_p) == 2
    if name == 'leaky':
        np.testing.assert_allclose(io_t, io_j, rtol=1e-4, atol=1e-4)
    else:
        d_prob = np.abs(io_t[..., 4:] - io_j[..., 4:])
        d_box = np.abs(io_t[..., :4] - io_j[..., :4])
        assert d_prob.mean() < 1e-3 and d_prob.max() < 0.05
        assert d_box.mean() < 0.05 and d_box.max() < 2.0


@pytest.mark.parametrize('cell_mode', [True, False])
def test_sparse_nms_on_int8_heads_matches_jax(calibrated, cell_mode):
    """non_max_suppression_heads(head_scales=...) on the same int8 heads
    (JAX's engine output), cell mode (obj maps) and row mode: rtol/atol
    1e-4."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.models.int8_engine import make_int8_apply as jmake
    from yolo_tpu.models.int8_engine import prepare_int8 as jprepare
    from yolo_tpu.ops.nms import non_max_suppression_heads as jnms
    from yolo_tpu_torch.ops.nms import non_max_suppression_heads
    _, jnet, cfg, params, state, qstate, x = calibrated['leaky']
    jplan = jprepare(jnet, params, state, qstate, cfg)
    eng = jmake(jnet, jplan, backend='xla', heads_only=True)
    heads, objs = jax.jit(eng)(jplan.arrays, jnp.asarray(x))
    yolos = [l for l in jnet.layers if l.kind == 'yolo']
    anchors = [l.anchors for l in yolos]
    strides = [l.yolo_stride for l in yolos]
    kw = dict(conf_thres=0.05, iou_thres=0.5, top_k=64, max_det=32)
    want = np.asarray(jnms(heads, anchors, strides, yolos[0].no,
                           objs=objs if cell_mode else None,
                           head_scales=eng.head_scales, **kw))
    theads = [torch.from_numpy(np.array(h)) for h in heads]
    tobjs = ([torch.from_numpy(np.array(o)) for o in objs] if cell_mode
             else None)
    got = non_max_suppression_heads(theads, anchors, strides, yolos[0].no,
                                    objs=tobjs, head_scales=eng.head_scales,
                                    **kw).numpy()
    assert (want[..., 4] > 0).sum() > 5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('sibling', [False, True])
def test_int8_serving_end_to_end_matches_jax(calibrated, tmp_path, sibling):
    """A JAX-calibrated toy saved as .npz (qstate in the file, or in the
    sibling _qstate.npz) -> load_model(quantized=1, device='cpu') ->
    make_infer(engine=True), against the JAX bundle's make_infer(engine=True)
    on the same checkpoint: rtol/atol 1e-4."""
    import jax.numpy as jnp
    from yolo_tpu import runtime as jrt
    from yolo_tpu.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch import runtime as trt
    path, _, _, params, state, qstate, x = calibrated['leaky']
    npz = tmp_path / 'calibrated.npz'
    if sibling:
        save_checkpoint(npz, params=params, state=state)
        save_checkpoint(tmp_path / 'calibrated_qstate.npz', params=qstate,
                        state={})
    else:
        save_checkpoint(npz, params=params, state=state, qstate=qstate)
    kw = dict(conf_thres=0.05, iou_thres=0.5, top_k=64, max_det=32)
    jb = jrt.load_model(path, str(npz), quantized=1, steps=100,
                        compute_dtype=jnp.float32)
    want = np.asarray(jb.make_infer(engine=True, **kw)(jnp.asarray(x)))
    tb = trt.load_model(path, str(npz), device='cpu', quantized=1, steps=100)
    infer = tb.make_infer(**kw)          # the engine is the default
    got = infer(trt.preprocess(images(2, 2, 64), device='cpu')).numpy()
    assert (want[..., 4] > 0).sum() > 5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('quantized', [1, -1])
def test_detect_cli_serves_calibrated_npz(calibrated, tmp_path, quantized):
    """``python -m yolo_tpu_torch.detect --quantized 1`` runs the int8
    engine on a calibrated .npz (and -1 the float path on the same file)
    on the CPU: boxes drawn and written for every image."""
    import cv2
    from yolo_tpu.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch import detect
    path, _, _, params, state, qstate, _ = calibrated['leaky']
    npz = tmp_path / 'calibrated.npz'
    save_checkpoint(npz, params=params, state=state, qstate=qstate)
    src, out = tmp_path / 'src', tmp_path / 'out'
    src.mkdir()
    cv2.imwrite(str(src / 'a.jpg'), images(9, 1, 64)[0])
    cv2.imwrite(str(src / 'b.png'), images(10, 1, 96)[0][:48])
    names = tmp_path / 'toy.names'
    names.write_text('a\nb\n')
    detect.main(['--cfg', path, '--weights', str(npz), '--source', str(src),
                 '--output', str(out), '--img-size', '64', '--conf-thres',
                 '0.05', '--names', str(names), '--device', 'cpu',
                 '--quantized', str(quantized), '--save-txt'])
    assert sorted(p.name for p in out.iterdir() if p.suffix != '.txt') == [
        'a.jpg', 'b.png']
    assert any(out.glob('*.txt'))


def test_port_calibration_then_engine_tracks_sim(tmp_path):
    """The whole port on the CPU: random weights, zero BN running stats (the
    first calibration batch is copied in), 3 calibration steps through
    ModelBundle.apply(train=True), then the int8 engine against the f32
    fake-quant sim: survivor counts within max(2, 20%), as the JAX
    package's test_make_infer_int8_engine allows (requant rounding)."""
    from yolo_tpu_torch import runtime as trt
    p = tmp_path / 'toy.cfg'
    p.write_text(TOY_CFG)
    b = trt.load_model(str(p), device='cpu', quantized=1, steps=100,
                       generator=torch.Generator().manual_seed(0))
    b.state = {k: {f: torch.zeros_like(t) for f, t in d.items()}
               for k, d in b.state.items()}
    x = trt.preprocess(images(3, 2, 64), device='cpu')
    q0 = b.qstate
    for _ in range(3):
        b.apply(x, train=True)
    assert b.qstate is not q0
    assert float(b.qstate['0']['step']) == 3.0
    assert all(bool((d['var'] > 0).all()) for d in b.state.values())
    kw = dict(conf_thres=0.05)
    d_sim = b.make_infer(engine=False, **kw)(x)
    d_eng = b.make_infer(engine=True, **kw)(x)
    assert d_eng.shape == d_sim.shape == (2, 300, 6)
    assert torch.isfinite(d_eng).all()
    n_sim, n_eng = int((d_sim[..., 4] > 0).sum()), int((d_eng[..., 4] > 0).sum())
    assert n_sim > 0 and abs(n_sim - n_eng) <= max(2, int(0.2 * n_sim))


REORG_CFG = """[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[route]
layers=-2

[reorg3d]
stride=2

[route]
layers=1,-1

[maxpool]
size=3
stride=1

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=0
filters=18
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,13, 16,30, 33,23
classes=1
num=3
"""


def test_engine_reorg3d_concat_maxpool_matches_jax(tmp_path_factory,
                                                   jax_highest):
    """reorg3d (space-to-depth on int8), a requantized concat of it with a
    deeper map, and a padded 3x3 maxpool on int8: heads bit-equal to the
    JAX engine."""
    jax = jax_highest
    import jax.numpy as jnp
    from yolo_tpu.models.int8_engine import make_int8_apply as jmake
    from yolo_tpu.models.int8_engine import prepare_int8 as jprepare
    from yolo_tpu_torch.models.int8_engine import make_int8_apply
    path = _write(tmp_path_factory, 'reorg.cfg', REORG_CFG)
    jnet, cfg, params, state, qstate, x = _jax_calibrated(path)
    jplan = jprepare(jnet, params, state, qstate, cfg)
    net, plan = _port_plan(path, params, state, qstate)
    hj, _ = jax.jit(jmake(jnet, jplan, backend='xla', heads_only=True))(
        jplan.arrays, jnp.asarray(x))
    ht, _ = make_int8_apply(net, plan, heads_only=True)(plan.arrays,
                                                        torch.from_numpy(x))
    assert len(ht) == 1
    np.testing.assert_array_equal(ht[0].numpy(), np.asarray(hj[0]))


def test_unported_int8_paths_raise(tmp_path):
    """A grouped conv on an int8 edge, and layer kinds the engine lacks,
    raise NotImplementedError naming ROADMAP.md."""
    from yolo_tpu_torch import runtime as trt
    grouped = TOY_CFG.replace('filters=16\nsize=3\nstride=2\npad=1\n',
                              'filters=16\nsize=3\nstride=2\npad=1\ngroups=2\n',
                              1)
    assert grouped != TOY_CFG
    p = tmp_path / 'grouped.cfg'
    p.write_text(grouped)
    b = trt.load_model(str(p), device='cpu', quantized=1, steps=100)
    x = trt.preprocess(images(3, 1, 64), device='cpu')
    b.apply(x, train=True)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        b.make_infer()(x)
    se = tmp_path / 'se.cfg'
    se.write_text(TOY_CFG.replace('[maxpool]\nsize=2\nstride=1\n',
                                  '[se]\nreduction=4\n'))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.load_model(str(se), device='cpu', quantized=1)


# ---------------------------------------------------------------- on the card

# the kernel's tile edges: pixels not a multiple of any tile (128 rows),
# Cout 32 and 255, Cin 32 (yolov3's 304 px layer) and 1024 (1x1 at 19 px),
# K*K*Cin = 4608 (3x3 512 -> 1024 at 19 px), stride 2 on odd sizes
EDGE_CASES = [
    (3, 23, 17, 32, 32, 3, 1, 'leaky', True),
    (1, 304, 304, 32, 64, 3, 1, 'leaky', True),
    (2, 19, 19, 1024, 255, 1, 1, 'linear', True),
    (2, 19, 19, 1024, 512, 1, 1, 'leaky', True),
    (1, 19, 19, 512, 1024, 3, 1, 'leaky', True),
    (2, 37, 29, 64, 128, 3, 2, 'leaky', True),
    (2, 13, 11, 48, 96, 3, 2, 'leaky', False),
]
EDGE_IDS = [f'{c[0]}x{c[1]}x{c[2]}_{c[5]}x{c[5]}s{c[6]}_{c[3]}to{c[4]}'
            f'_{c[7]}_{"int8" if c[8] else "f32"}' for c in EDGE_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize('case', CASES + [(2, 11, 13, 6, 255, 3, 1, 'leaky',
                                           True)] + EDGE_CASES,
                         ids=CASE_IDS + ['3x3s1_6to255_leaky'] + EDGE_IDS)
def test_k2_kernel_matches_plain(cuda, case):
    """The kernel against its plain version on the card: int8 outputs
    bit-equal for leaky/linear/relu; for mish at most 1 LSB apart on at
    most 0.1% of the values (the kernel's and PyTorch's transcendentals
    may differ by an ulp); f32 outputs rtol 1e-6 (the epilogue is the
    same sequence of IEEE operations). The tile-edge cases take an output
    scale that spreads their outputs over the int8 grid (std about 40
    quanta) instead of saturating at their deep sums."""
    from yolo_tpu_torch.ops.conv_int8 import (fused_conv_int8,
                                              fused_conv_int8_reference)
    n, h, w, ci, co, k, s, act, out_q = case
    x8, w8, bias = _conv_case(case)
    oscale = 2.0 ** -2
    if case in EDGE_CASES:
        acc_std = (k * k * ci) ** 0.5 * 74.0 * 23.4
        oscale = 2.0 ** round(np.log2(acc_std * 2.0 ** -9 / 40.0))
    args = (torch.from_numpy(x8).to(cuda), _ohwi(w8).to(cuda),
            torch.from_numpy(bias).to(cuda), 2.0 ** -9, oscale)
    kw = dict(stride=s, act=act, out_q=out_q)
    n0 = fused_conv_int8.launches
    got = fused_conv_int8(*args, **kw)
    torch.cuda.synchronize()
    assert fused_conv_int8.launches == n0 + 1
    want = fused_conv_int8_reference(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    if not out_q:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    elif act == 'mish':
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_int8_serving_on_card_matches_cpu(cuda, tmp_path):
    """Calibration, the engine through K2 and the sparse NMS through K1 on
    the card (TF32 off) against the same pipeline on the CPU through the
    plain twins: int8 heads bit-equal for the leaky cfg, detections within
    rtol/atol 1e-4."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.models.int8_engine import make_int8_apply, prepare_int8
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    p = tmp_path / 'leaky.cfg'
    p.write_text(LEAKY_CFG)
    bundles = {}
    for dev in ('cpu', cuda):
        b = trt.load_model(str(p), device=dev, quantized=1, steps=100,
                           generator=torch.Generator().manual_seed(0))
        for _ in range(3):
            b.apply(trt.preprocess(images(3, 2, 64), device=dev), train=True)
        bundles[dev] = b
    # the card's calibration may round a scale apart: serve both from the
    # CPU's calibration
    cpu = bundles['cpu']
    card = bundles[cuda]
    card.state = {k: {f: t.to(cuda) for f, t in d.items()}
                  for k, d in cpu.state.items()}
    card.qstate = {k: {f: (v.to(cuda) if torch.is_tensor(v) else
                           {g: u.to(cuda) for g, u in v.items()})
                       for f, v in d.items()} for k, d in cpu.qstate.items()}
    x = images(4, 2, 64)
    heads = {}
    for dev, b in ((None, cpu), (cuda, card)):
        plan = prepare_int8(b.net, b.params, b.state, b.qstate, b.qcfg)
        eng = make_int8_apply(b.net, plan, heads_only=True)
        n0 = fused_conv_int8.launches
        heads[dev] = eng(plan.arrays, trt.preprocess(x, device=dev or 'cpu'))[0]
        if dev is not None:
            torch.cuda.synchronize()
            assert fused_conv_int8.launches - n0 == 10   # 11 convs - stem
    for a, b in zip(heads[None], heads[cuda]):
        assert torch.equal(a, b.cpu())
    kw = dict(conf_thres=0.05, iou_thres=0.5, top_k=64, max_det=32)
    ref = cpu.make_infer(**kw)(trt.preprocess(x, device='cpu'))
    got = card.make_infer(**kw)(trt.preprocess(x, device=cuda))
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
