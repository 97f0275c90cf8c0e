"""The port's knowledge distillation strategies
(``yolo_tpu_torch.train.kd``) against the JAX package, on the CPU (the KD
step and loop: ``test_torch_kd_train.py``).

The same numpy-seeded inputs go through the JAX function and the port, in
f32 with JAX at 'highest' matmul precision: ``kd1``-``kd6`` and
``failure_case_loss_fm``, in both head layouts, within rtol 1e-5 (f32
sums over the same rows in another order); ``_foreground_mask`` in 'diag'
and 'rect' modes bit-equal.
"""

import os
import sys

import numpy as np
import pytest
import torch


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NC = 2
BS = 2
STRIDES = (32, 16, 8)
IMG = 64
# (ny, nx) per head at 64 px: strides 32, 16 and 8
GRIDS = ((2, 2), (4, 4), (8, 8))
# KD feature maps (NHWC): the stem's scale down to the coarsest head's
FEATS = ((64, 64, 3), (32, 32, 4), (16, 16, 5), (8, 8, 6), (8, 8, 4),
         (4, 4, 7), (2, 2, 3))


@pytest.fixture(scope='module', autouse=True)
def _setup():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    import jax
    prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old)
    jax.config.update('jax_default_matmul_precision', prec)


def kd_targets(seed, bs=BS, n=20, cap=24):
    """(targets (cap, 6), valid (cap,)): ``n`` boxes, one on the image's
    right and bottom edge (x = y = 1, a cell index past the grid), two in
    one cell, and padded rows that point at an image past the batch."""
    rng = np.random.default_rng(seed)
    t = np.zeros((cap, 6), np.float32)
    t[:n, 0] = rng.integers(0, bs, n)
    t[:n, 1] = rng.integers(0, NC, n)
    t[:n, 2:4] = rng.uniform(0.05, 0.95, (n, 2))
    t[:n, 4:6] = rng.uniform(0.05, 0.7, (n, 2))
    t[1, :4] = t[0, :4]
    t[1, 4:6] = t[0, 4:6] * 0.8
    t[2, 2:4] = 1.0
    t[n:, 0] = bs + 3
    t[n:, 2:6] = 0.5
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return t, valid


def kd_inputs(seed):
    """Anchor-major student and teacher heads (bs, na, ny, nx, no), NHWC
    feature maps of both, targets and the anchor vectors, numpy f32."""
    rng = np.random.default_rng(seed)
    heads = lambda: [rng.normal(0, 1.5, (BS, 3, ny, nx, NC + 5))
                     .astype(np.float32) for ny, nx in GRIDS]
    feats = lambda: [rng.normal(0, 1, (BS,) + s).astype(np.float32)
                     for s in FEATS]
    anchors = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                        [59, 119], [116, 90], [156, 198], [373, 326]],
                       np.float32)
    avecs = [anchors[6:] / 32, anchors[3:6] / 16, anchors[:3] / 8]
    t, v = kd_targets(seed + 1)
    return heads(), heads(), feats(), feats(), t, v, avecs


def _layout(heads, layout):
    return [h.transpose(0, 2, 3, 1, 4).copy() if layout == 'nhwc' else h
            for h in heads]


def _strategy_pair(name, layout, seed=0, jax_too=True):
    """(JAX value, port value) of strategy ``name`` on one input set; the
    JAX value is None unless ``jax_too``."""
    import jax.numpy as jnp
    from yolo_tpu.train import kd as J
    from yolo_tpu_torch.train import kd as T
    ps, pt, fs, ft, t, v, av = kd_inputs(seed)
    ps, pt = _layout(ps, layout), _layout(pt, layout)
    j = lambda xs: [jnp.asarray(a) for a in xs]
    tt = lambda xs: [torch.from_numpy(a) for a in xs]
    jt, jv = jnp.asarray(t), jnp.asarray(v)
    tt_, tv = torch.from_numpy(t), torch.from_numpy(v)
    tav = tt(av)
    if not jax_too:
        J = _NoJax()
    if name == 'kd1':
        return (J.kd1(j(ps), j(pt), NC, BS), T.kd1(tt(ps), tt(pt), NC, BS))
    if name == 'kd2':
        a = J.kd2(j(ps), j(pt), jt, jv, av, NC, layout=layout)
        b = T.kd2(tt(ps), tt(pt), tt_, tv, tav, NC, layout=layout)
        return (None if a is None else np.array([float(a[0]), float(a[1])]),
                torch.stack(b))
    if name == 'kd3':
        return (J.kd3(j(ps), j(pt), jt, jv, av, NC, layout=layout),
                T.kd3(tt(ps), tt(pt), tt_, tv, tav, NC, layout=layout))
    if name == 'kd4':
        return (J.kd4(j(ps), j(pt), j(fs), j(ft), jt, jv, av, NC, BS,
                      layout=layout),
                T.kd4(tt(ps), tt(pt), tt(fs), tt(ft), tt_, tv, tav, NC, BS,
                      layout=layout))
    if name.startswith('kd5'):
        mode = name.split('_')[1]
        return (J.kd5(j(ps), j(pt), j(fs), j(ft), jt, jv, av, NC, BS, IMG,
                      STRIDES, mask_mode=mode, layout=layout),
                T.kd5(tt(ps), tt(pt), tt(fs), tt(ft), tt_, tv, tav, NC, BS,
                      IMG, STRIDES, mask_mode=mode, layout=layout))
    assert name == 'kd6' and layout == 'anchor_major'
    return (J.kd6(j(ps), j(pt), jt, jv, av, NC, BS),
            T.kd6(tt(ps), tt(pt), tt_, tv, tav, NC, BS))


class _NoJax:
    """Stands in for the JAX module where only the port's value is
    wanted: every strategy returns None."""

    def __getattr__(self, name):
        return lambda *a, **k: None


@pytest.mark.parametrize('layout', ['nhwc', 'anchor_major'])
@pytest.mark.parametrize('name', ['kd1', 'kd2', 'kd3', 'kd4', 'kd5_rect',
                                  'kd5_diag'])
def test_strategy_matches_jax(name, layout):
    """Each strategy of the port equals JAX's within rtol 1e-5, in both
    head layouts, and the layouts give the same value."""
    want, got = _strategy_pair(name, layout)
    got = got.detach().numpy()
    assert np.all(np.asarray(want) != 0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    other = 'anchor_major' if layout == 'nhwc' else 'nhwc'
    np.testing.assert_allclose(
        got, _strategy_pair(name, other, jax_too=False)[1].detach().numpy(),
        rtol=1e-5)


def test_kd6_matches_jax():
    """KD6 (anchor-major heads only) within rtol 1e-5."""
    want, got = _strategy_pair('kd6', 'anchor_major')
    assert float(want) > 0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)


@pytest.mark.parametrize('mode', ['diag', 'rect'])
def test_foreground_mask_bit_equal(mode):
    """KD5's foreground mask at every feature size, bit-equal to JAX's:
    the edge target's cells, the shared cell and the padded rows (dropped
    by JAX, written to the dump row by the port)."""
    import jax.numpy as jnp
    from yolo_tpu.train import kd as J
    from yolo_tpu_torch.train import kd as T
    ps, _, _, _, t, v, av = kd_inputs(3)
    jl = J._per_layer_targets([jnp.asarray(p) for p in ps], jnp.asarray(t),
                              jnp.asarray(v), av)
    tl = T._per_layer_targets([torch.from_numpy(p) for p in ps],
                              torch.from_numpy(t), torch.from_numpy(v),
                              [torch.from_numpy(a) for a in av])
    marked = 0
    for h in (64, 32, 16, 8, 4, 2):
        want = np.asarray(J._foreground_mask(h, h, jl, STRIDES, IMG,
                                             mode)(BS))
        got = T._foreground_mask(h, h, tl, STRIDES, IMG, mode)(BS)
        assert got.dtype == torch.float32 and got.shape == (BS, h, h)
        np.testing.assert_array_equal(got.numpy(), want)
        marked += int(want.sum())
    assert marked > 0


@pytest.mark.parametrize('layout', ['nhwc', 'anchor_major'])
def test_failure_case_loss_matches_jax(layout):
    """``failure_case_loss_fm`` (nothing calls it, as in JAX) within rtol
    1e-5; None masks give 0."""
    import jax.numpy as jnp
    from yolo_tpu.train.kd import failure_case_loss_fm as J
    from yolo_tpu_torch.train.kd import failure_case_loss_fm as T
    rng = np.random.default_rng(5 if layout == 'nhwc' else 6)
    imgs = rng.uniform(0, 1, (BS, 16, 16, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (BS, 16, 16, 3)) > 0.3).astype(np.float32)
    t, v = kd_targets(7)
    want = J(jnp.asarray(masks), jnp.asarray(imgs), jnp.asarray(t),
             jnp.asarray(v))
    got = T(torch.from_numpy(masks), torch.from_numpy(imgs),
            torch.from_numpy(t), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert float(T(None, torch.from_numpy(imgs), torch.from_numpy(t),
                   torch.from_numpy(v))) == 0.0


def test_make_kd_loss_fn_checks():
    """KD6 refuses the NHWC layout; an unknown strategy raises."""
    from yolo_tpu_torch.train.kd import make_kd_loss_fn
    with pytest.raises(AssertionError, match='KD6'):
        make_kd_loss_fn(6, None, NC, [], layout='nhwc')
    with pytest.raises(ValueError, match='strategy 7'):
        make_kd_loss_fn(7, None, NC, [])
    assert make_kd_loss_fn(5, None, NC, [], layout='nhwc').layout == 'nhwc'
