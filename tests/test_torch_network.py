"""yolo_tpu_torch models, weights I/O and converter against the JAX package.

Weights come from ``random_jax_weights`` (numpy, seeded) in the JAX layout
and reach the port through ``convert.from_jax``. Forward outputs are held to
rtol/atol 1e-4 with JAX at 'highest' precision: both sides compute in f32,
with different summation orders inside the convs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, random_jax_weights
from yolo_tpu.ir import build_ir
from yolo_tpu.models import darknet_io as jio
from yolo_tpu.models.network import fuse_params as jfuse
from yolo_tpu.models.network import make_apply
from yolo_tpu_torch.convert import from_jax, to_jax
from yolo_tpu_torch.models import darknet_io as tio
from yolo_tpu_torch.models.network import (Darknet, check_supported,
                                           fuse_params, init_params)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module', autouse=True)
def _setup():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    old_prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    jax.config.update('jax_default_matmul_precision', old_prec)
    torch.set_num_threads(old_threads)


@pytest.fixture(scope='module')
def toy_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp('cfg') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return str(p)


def _cfg(name, toy_cfg, repo_root):
    return toy_cfg if name == 'toy' else f'{repo_root}/cfg/{name}'


NETS = [('toy', 64, 1.0), ('yolov3tiny/yolov3-tiny.cfg', 64, 1.0),
        ('yolov4tiny/yolov4-tiny.cfg', 64, 1.0),
        ('yolov3/yolov3.cfg', 64, 0.7), ('yolov4/yolov4.cfg', 64, 0.7)]


# maxabsscaler changes only the leaky slope: two nets with leaky cover it
EVAL_CASES = [n + (False,) for n in NETS] + [n + (True,) for n in NETS[:2]]


@pytest.mark.parametrize('name,size,scale,maxabs', EVAL_CASES,
                         ids=[f'{n}-{m}' for n, _, _, m in EVAL_CASES])
def test_eval_forward_matches_jax(name, size, scale, maxabs, toy_cfg,
                                  repo_root):
    net = build_ir(_cfg(name, toy_cfg, repo_root))
    pj, sj = random_jax_weights(net, seed=1, conv_scale=scale)
    x = np.random.default_rng(2).uniform(0, 1, (2, size, size, 3))
    x = x.astype(np.float32)
    io_j, _, _ = jax.jit(make_apply(net, compute_dtype=None,
                                    maxabsscaler=maxabs))(pj, sj, jnp.asarray(x))
    pt, st = from_jax(net, pj, sj)
    model = Darknet(net, pt, st, maxabsscaler=maxabs).eval()
    with torch.no_grad():
        io_t = model(torch.from_numpy(x))
    assert io_t.shape == io_j.shape and io_t.dtype == torch.float32
    np.testing.assert_allclose(io_t.numpy(), np.asarray(io_j), **TOL)


@pytest.mark.parametrize('name,size,scale', NETS, ids=[n for n, _, _ in NETS])
def test_fused_heads_only_matches_jax(name, size, scale, toy_cfg, repo_root):
    net = build_ir(_cfg(name, toy_cfg, repo_root))
    pj, sj = random_jax_weights(net, seed=3, conv_scale=scale)
    x = np.random.default_rng(4).uniform(0, 1, (2, size, size, 3))
    x = x.astype(np.float32)
    fj = jfuse(net, pj, sj)
    heads_j, objs_j = jax.jit(make_apply(net, compute_dtype=None, fused=True,
                                         heads_only=True))(fj, {}, jnp.asarray(x))
    pt, st = from_jax(net, pj, sj)
    model = Darknet(net, fuse_params(net, pt, st), fused=True).to(
        memory_format=torch.channels_last).eval()
    with torch.no_grad():
        heads_t, objs_t = model.forward_heads(torch.from_numpy(x))
    assert len(heads_t) == len(heads_j) == len(objs_t)
    for hj, ht, oj, ot in zip(heads_j, heads_t, objs_j, objs_t):
        assert ht.is_contiguous()          # NHWC view of channels_last: free
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        assert (oj is None) == (ot is None)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    # the fused eval forward equals the unfused one
    with torch.no_grad():
        io_f = model(torch.from_numpy(x))
        io_u = Darknet(net, pt, st).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(io_f.numpy(), io_u.numpy(), rtol=1e-3, atol=1e-3)


LONE_BN_CFG = """[net]
width=32
height=32
channels=3

[BatchNorm2d]

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=relu6

[BatchNorm2d]

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14,  23,27,  37,58
classes=2
num=3
"""


def test_lone_batchnorm_layers_match_jax(tmp_path):
    """Standalone [BatchNorm2d] blocks (eps 1e-4), including the leading
    3-channel input normaliser that init_params fills with imagenet stats."""
    p = tmp_path / 'bn.cfg'
    p.write_text(LONE_BN_CFG)
    net = build_ir(str(p))
    assert [l.kind for l in net.layers][:2] == ['batchnorm', 'conv']
    pj, sj = random_jax_weights(net, seed=8)
    x = np.random.default_rng(9).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    io_j, _, _ = jax.jit(make_apply(net, compute_dtype=None))(pj, sj,
                                                              jnp.asarray(x))
    pt, st = from_jax(net, pj, sj)
    with torch.no_grad():
        io_t = Darknet(net, pt, st).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(io_t.numpy(), np.asarray(io_j), **TOL)
    _, s0 = init_params(net)
    np.testing.assert_allclose(s0['0']['mean'].numpy(), [0.485, 0.456, 0.406])


def test_converter_round_trip(repo_root):
    # a cfg with depthwise convs and SE blocks: every field kind converts
    net = build_ir(f'{repo_root}/cfg/yolov3tiny-mobilenet-small/'
                   'yolov3tiny-mobilenet-small-coco.cfg')
    pj, sj = random_jax_weights(net, seed=0)
    assert any(l.kind == 'se' for l in net.layers)
    assert any(l.kind == 'depthwise' for l in net.layers)
    pt, st = from_jax(net, pj, sj)
    for lyr in net.layers:
        if lyr.kind in ('conv', 'depthwise'):
            w = pt[str(lyr.index)]['w']
            assert tuple(w.shape) == (lyr.filters, lyr.in_channels // lyr.groups,
                                      lyr.size, lyr.size)
    pj2, sj2 = to_jax(net, pt, st)
    for src, back in ((pj, pj2), (sj, sj2)):
        assert src.keys() == back.keys()
        for k in src:
            assert src[k].keys() == back[k].keys()
            for f in src[k]:
                np.testing.assert_array_equal(back[k][f], np.asarray(src[k][f]))


def test_jax_weights_file_loads_and_resaves_identically(toy_cfg, repo_root,
                                                        tmp_path):
    net = build_ir(f'{repo_root}/cfg/yolov3tiny/yolov3-tiny.cfg')
    pj, sj = random_jax_weights(net, seed=5)
    src = tmp_path / 'jax.weights'
    jio.save_darknet_weights(net, pj, sj, src, seen=[1234])
    p0, s0 = init_params(net, torch.Generator().manual_seed(9))
    pt, st, version, seen = tio.load_darknet_weights(net, p0, s0, src)
    assert version.tolist() == [0, 2, 5] and seen.tolist() == [1234]
    want_p, want_s = from_jax(net, pj, sj)
    for got, want in ((pt, want_p), (st, want_s)):
        for k in want:
            for f in want[k]:
                assert torch.equal(got[k][f], want[k][f]), (k, f)
    out = tmp_path / 'port.weights'
    tio.save_darknet_weights(net, pt, st, out, version=version, seen=seen)
    assert out.read_bytes() == src.read_bytes()


def test_weights_cutoff_and_pt(repo_root, tmp_path):
    net = build_ir(f'{repo_root}/cfg/yolov3tiny/yolov3-tiny.cfg')
    pj, sj = random_jax_weights(net, seed=6)
    src = tmp_path / 'full.weights'
    jio.save_darknet_weights(net, pj, sj, src)
    jp, js = random_jax_weights(net, seed=7)
    p0, s0 = from_jax(net, jp, js)
    for kw in (dict(cutoff=10), dict(pt=True)):
        want_p, want_s, _, _ = jio.load_darknet_weights(net, jp, js, src, **kw)
        got_p, got_s, _, _ = tio.load_darknet_weights(net, p0, s0, src, **kw)
        want_p, want_s = from_jax(net, want_p, want_s)
        for k in want_p:
            for f in want_p[k]:
                assert torch.equal(got_p[k][f], want_p[k][f]), (kw, k, f)
    with open(src, 'ab') as f:                  # one float too many
        np.zeros(1, np.float32).tofile(f)
    with pytest.raises(ValueError):
        tio.load_darknet_weights(net, p0, s0, src)


def test_init_params_seeded_with_smart_bias(toy_cfg):
    net = build_ir(toy_cfg)
    a, sa = init_params(net, torch.Generator().manual_seed(0), conv_scale=0.6)
    b, _ = init_params(net, torch.Generator().manual_seed(0), conv_scale=0.6)
    c, _ = init_params(net, torch.Generator().manual_seed(1), conv_scale=0.6)
    assert all(torch.equal(a[k][f], b[k][f]) for k in a for f in a[k])
    assert not torch.equal(a['0']['w'], c['0']['w'])
    head = a['12']['b'].view(3, 7)
    assert float(head[:, 4].max()) < -4.0        # objectness prior -4.5
    v = sa['0']['var']
    assert v.shape == (8,) and float(v.min()) >= 0.5 and float(v.max()) <= 2.0
    # the OIHW layout the JAX init would give, damped by conv_scale
    assert tuple(a['1']['w'].shape) == (16, 8, 3, 3)
    assert abs(float(a['1']['w'].std()) - 0.6 * (2 / 72) ** 0.5) < 0.02


@pytest.mark.parametrize('cfg,what', [
    ('yolov3/yolov3-asff.cfg', 'ASFF'),
    ('yolov3/yolov3-spp-pan-scale.cfg', 'reorg3d'),
    ('yolov3-mobilenet/yolov3-mobilenet-coco.cfg', 'depthwise'),
    ('yolov3tiny-efficientnetB0/yolov3tiny-efficientnetB0.cfg', 'avgpool'),
])
def test_unported_layers_raise(repo_root, cfg, what):
    """The layer kinds the port's first slices lacked now build: the cfg
    holds the kind, ``check_supported`` passes, and the port's own random
    init runs the forward at 64 px to finite io."""
    from yolo_tpu_torch.ir import build_ir as tbuild
    from yolo_tpu_torch.models.network import _asff_yolo
    net = tbuild(f'{repo_root}/cfg/{cfg}')
    if what == 'ASFF':
        assert len(_asff_yolo(net)) == 3
    else:
        assert any(l.kind == what for l in net.layers)
    check_supported(net)
    p, s = init_params(net, torch.Generator().manual_seed(0), conv_scale=0.7)
    with torch.no_grad():
        io = Darknet(net, p, s).eval()(torch.rand(1, 64, 64, 3))
    n_rows = sum(l.na * (64 // l.yolo_stride) ** 2
                 for l in net.layers if l.kind == 'yolo')
    assert io.shape == (1, n_rows, net.nc + 5)
    assert bool(torch.isfinite(io).all())


def _same(a, b, where):
    """Recursive equality of IR values (dicts, sequences, numpy arrays)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{where}[{i}]')
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_ir_copy_matches_jax_on_every_cfg(repo_root):
    """The port's own cfg parser and IR construction (yolo_tpu_torch/config.py,
    ir.py) give the JAX package's IR, field for field, on every cfg."""
    import dataclasses
    import glob
    from yolo_tpu_torch.ir import build_ir as tbuild
    cfgs = sorted(glob.glob(f'{repo_root}/cfg/**/*.cfg', recursive=True))
    assert len(cfgs) > 30
    for path in cfgs:
        for gray in (False, True):
            a, b = build_ir(path, is_gray_scale=gray), tbuild(path, is_gray_scale=gray)
            assert (a.in_channels, a.cfg_name) == (b.in_channels, b.cfg_name)
            _same(a.module_defs, b.module_defs, f'{path} mdefs')
            assert len(a.layers) == len(b.layers), path
            for la, lb in zip(a.layers, b.layers):
                _same(dataclasses.asdict(la), dataclasses.asdict(lb),
                      f'{path} layer {la.index}')
