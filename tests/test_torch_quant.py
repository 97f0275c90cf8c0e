"""The port's google-scheme fake-quant sim (yolo_tpu_torch/compress/quant.py)
against the JAX package's (yolo_tpu/compress/quant.py), on the CPU.

Inputs come from numpy seeds and go through both packages. The calibration
input is an image batch / 256 (what ``preprocess`` makes), so every conv
whose input sits on a fake-quant grid (all but the BN statistics convs) is
exact in f32 on both sides whatever the summation order. JAX runs at
'highest' matmul precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights
from yolo_tpu.compress import quant as JQ
from yolo_tpu.ir import build_ir
from yolo_tpu_torch.compress import quant as TQ
from yolo_tpu_torch.convert import from_jax, qstate_from_jax, qstate_to_jax


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
def toy_net(tmp_path_factory):
    p = tmp_path_factory.mktemp('qcfg') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return build_ir(str(p))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_round_half_away_matches_jax():
    """Ties go away from zero (torch.round would send 0.5 and 2.5 to the
    even neighbour); exact against JAX."""
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.0, -0.0, 126.5],
                    np.float32)
    x = np.concatenate([ties, np.random.default_rng(0).normal(
        0, 50, 1000).astype(np.float32)])
    got = TQ.round_half_away(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JQ.round_half_away(x)))
    np.testing.assert_array_equal(got[:6], [1, -1, 2, -2, 3, -3])


def test_pow2_snap_and_qrange_match_jax():
    """Exact against JAX over [2^-12, 2^12], where XLA's CPU exp2 returns
    exact powers of two (outside it XLA rounds 2^n off by an ulp, e.g.
    2^13 -> 8192.0039, and it flushes denormals); calibrated ranges lie
    inside. The port's snaps are exact powers of two everywhere."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        [1.0, 1.4, 1.6, 3.0, 0.3, 6.0, 12.0, 2.0 ** -12, 4095.0],
        np.exp2(rng.uniform(-12, 12, 2000))]).astype(np.float32)
    got = TQ.pow2_snap(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JQ.pow2_snap(x)))
    np.testing.assert_array_equal(got[:5], [1.0, 1.0, 2.0, 2.0, 0.25])
    wide = np.exp2(rng.uniform(-30, 30, 2000)).astype(np.float32)
    mant = np.frexp(TQ.pow2_snap(_t(wide)).numpy())[0]
    np.testing.assert_array_equal(mant, 0.5)
    for bits in (4, 8, 16):
        for sign in (True, False):
            assert TQ.qrange(bits, sign) == JQ.qrange(bits, sign)


@pytest.mark.parametrize('bits,scale,zp', [(8, 2.0 ** -4 / 127, 0.0),
                                           (8, 2.0 ** -7, 3.0),
                                           (4, 0.25, 0.0)])
def test_fq_matches_jax(bits, scale, zp):
    """Fake quantization, clamped values included: exact."""
    x = np.random.default_rng(bits).normal(0, 0.05, 4096).astype(np.float32)
    x[:8] = [10.0, -10.0, 0.5, -0.5, 1e-9, -1e-9, 0.0, 3.0]
    got = TQ.fq(_t(x), scale, zp, bits).numpy()
    want = np.asarray(JQ.fq(jnp.asarray(x), scale, zp, bits))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('track', ['ema', 'global'])
def test_tracker_quantizer_matches_jax(track):
    """Range tracking (EMA, and the aliasing 'global' tracker whose range
    is the current batch's clamped through zero), pow-2 scale updates and
    the freeze step: every state field exact over 6 steps."""
    rng = np.random.default_rng(2)
    qj, qt = JQ.tracker_init(), TQ.tracker_init()
    for step in range(6):
        x = (rng.normal(0.3, 1.0 + step, 500)).astype(np.float32)
        yj, qj = JQ.google_quantize(jnp.asarray(x), qj, bits=8, train=True,
                                    freeze_step=4, track=track)
        yt, qt = TQ.google_quantize(_t(x), qt, bits=8, train=True,
                                    freeze_step=4, track=track)
        np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
        for f in qj:
            assert float(qt[f]) == float(qj[f]), (step, f)
    assert float(qt['step']) == 6.0
    y, q2 = TQ.google_quantize(_t(x), qt, bits=8, train=False, freeze_step=4)
    assert q2 is qt
    y32, _ = TQ.google_quantize(_t(x), qt, bits=32, train=True, freeze_step=4)
    assert torch.equal(y32, _t(x))


def test_quant_config_and_unported_schemes(toy_net):
    """The freeze steps match JAX's; the five other schemes, which the
    first slice refused, now build (tests/test_torch_quant_schemes.py
    holds them to JAX's), and an unknown scheme raises ValueError."""
    cfg = TQ.QuantConfig(steps=100)
    jcfg = JQ.QuantConfig(steps=100)
    assert (cfg.bn_freeze_step, cfg.scale_freeze_step) == (
        jcfg.bn_freeze_step, jcfg.scale_freeze_step) == (90, 10)
    for scheme in ('tpsq', 'ptq_cos', 'dorefa', 'wbin', 'ternary'):
        TQ.init_quant_state(toy_net, TQ.QuantConfig(scheme=scheme))
        assert TQ.make_quant_apply(toy_net, TQ.QuantConfig(
            scheme=scheme)).qcfg.scheme == scheme
    for fn in (TQ.init_quant_state, TQ.make_quant_apply):
        with pytest.raises(ValueError, match='scheme'):
            fn(toy_net, TQ.QuantConfig(scheme='lsq'))


def test_qstate_round_trip_and_layout(toy_net):
    """init_quant_state has the JAX tree's keys and values; the converters
    round-trip a calibrated-looking qstate exactly."""
    cfg = TQ.QuantConfig()
    qt, extra = TQ.init_quant_state(toy_net, cfg)
    qj, _ = JQ.init_quant_state(toy_net, JQ.QuantConfig())
    assert extra == {}
    back = qstate_to_jax(qt)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    same(back, jax.tree_util.tree_map(np.asarray, qj))
    rng = np.random.default_rng(3)
    noisy = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a))).astype(
            np.float32), qj)
    same(qstate_to_jax(qstate_from_jax(noisy)), noisy)


@pytest.mark.parametrize('zero_stats', [False, True])
@pytest.mark.parametrize('train', [False, True])
def test_bn_fold_matches_jax(zero_stats, train):
    """The two-phase BN fold on the same conv output: batch statistics, the
    first-batch copy only while the running stats are all zero, the EMA of
    momentum 0.01 otherwise, and the folded scale and bias. rtol 1e-6 /
    atol 1e-7: the batch mean and variance are f32 reductions summed in
    other orders."""
    rng = np.random.default_rng(4)
    c = 12
    out_f = rng.normal(0.2, 1.5, (2, 9, 9, c)).astype(np.float32)
    p = {'gamma': rng.uniform(0.6, 1.4, c), 'beta': rng.normal(0, 0.1, c),
         'b': rng.normal(0, 0.1, c)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    st = {'mean': rng.normal(0, 0.3, c), 'var': rng.uniform(0.5, 2.0, c)}
    st = {k: (np.zeros(c) if zero_stats else v).astype(np.float32)
          for k, v in st.items()}
    for step in (0.0, 95.0):          # before and after bn_freeze_step 90
        qs = {'first_bn': np.float32(0.0), 'step': np.float32(step)}
        want = JQ._bn_fold(p, st, qs, jnp.asarray(out_f), train,
                           JQ.QuantConfig(steps=100), has_bias=True)
        got = TQ._bn_fold({k: _t(v) for k, v in p.items()},
                          {k: _t(v) for k, v in st.items()},
                          {k: _t(v) for k, v in qs.items()}, _t(out_f),
                          train, TQ.QuantConfig(steps=100))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        for f in ('mean', 'var'):
            np.testing.assert_allclose(got[2][f].numpy(),
                                       np.asarray(want[2][f]), rtol=1e-6,
                                       atol=1e-7)
        assert float(got[3]['first_bn']) == float(want[3]['first_bn'])
        if train and zero_stats:        # the batch statistics were copied
            np.testing.assert_allclose(got[2]['mean'].numpy(),
                                       out_f.mean((0, 1, 2)), rtol=1e-5,
                                       atol=1e-6)


def _calibrate(net, way, steps=3):
    """3 train-mode steps of both sims from the same weights and images."""
    pj, sj = random_jax_weights(net, seed=0, conv_scale=1.0)
    x = images(2, 2, 64).astype(np.float32) / 256.0
    jcfg = JQ.QuantConfig(steps=100, shortcut_way=way)
    tcfg = TQ.QuantConfig(steps=100, shortcut_way=way)
    japply = JQ.make_quant_apply(net, jcfg, compute_dtype=None)
    tapply = TQ.make_quant_apply(net, tcfg)
    jq = JQ.init_quant_state(net, jcfg)[0]
    tq = TQ.init_quant_state(net, tcfg)[0]
    pt, st = from_jax(net, pj, sj)
    js, ts = sj, st
    for _ in range(steps):
        _, js, jq = japply(pj, js, jq, jnp.asarray(x), True)
        _, ts, tq = tapply(pt, ts, tq, torch.from_numpy(x), True)
    return (japply, pj, js, jq), (tapply, pt, ts, tq), x


@pytest.mark.parametrize('way', [1, 2])
def test_google_calibration_matches_jax(toy_net, way):
    """3 calibration steps at f32, shortcut ways 1 and 2.

    Every tracker scale is equal: they are pow-2 snapped. The BN running
    statistics agree within rtol 1e-5 plus an atol of 1e-3 of the channel's
    std: the batch-statistics convs take float weights, so the two
    frameworks sum them in other orders, and means near zero carry that
    noise. The eval sim's io agrees within rtol/atol 1e-4 on all but 0.1%
    of its values: an activation that lands on a requantization boundary
    can round one quantum apart, and that quantum moves the io downstream
    of it (then by less than 0.05 in a score and 2 px on a 64 px image, the
    bounds of the JAX package's own engine-vs-sim test)."""
    (japply, pj, js, jq), (tapply, pt, ts, tq), x = _calibrate(toy_net, way)
    tqj = qstate_to_jax(tq)
    n_scales = 0
    for k, d in jq.items():
        for f, v in d.items():
            if isinstance(v, dict):
                assert float(tqj[k][f]['scale']) == float(v['scale']), (k, f)
                n_scales += 1
        if 'scale' in d:
            assert float(tqj[k]['scale']) == float(d['scale']), k
    assert n_scales > 30
    assert js.keys() == ts.keys()
    for k in js:
        std = np.sqrt(np.asarray(js[k]['var']))
        for f in ('mean', 'var'):
            got, want = ts[k][f].numpy(), np.asarray(js[k][f])
            assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)
                          + 1e-3 * std), (k, f)

    io_j = np.asarray(japply(pj, js, jq, jnp.asarray(x), False)[0])
    io_t, yolo_p, feats = tapply(pt, ts, tq, torch.from_numpy(x), False)
    io_t = io_t.numpy()
    assert io_t.shape == io_j.shape and np.isfinite(io_t).all()
    off = np.abs(io_t - io_j) > 1e-4 + 1e-4 * np.abs(io_j)
    assert off.mean() < 1e-3, off.sum()
    assert np.abs(io_t[..., 4:] - io_j[..., 4:]).max() < 0.05
    assert np.abs(io_t[..., :4] - io_j[..., :4]).max() < 2.0
    assert len(yolo_p) == 2 and yolo_p[0].shape == (2, 3, 16, 16, 7)


def test_eval_sim_heads_only(toy_net):
    """heads_only returns the raw NHWC heads of the eval io (row mode)."""
    _, (tapply, pt, ts, tq), x = _calibrate(toy_net, 1, steps=1)
    heads_fn = TQ.make_quant_apply(toy_net, tapply.qcfg, heads_only=True)
    heads, objs = heads_fn(pt, ts, tq, torch.from_numpy(x))
    _, yolo_p, _ = tapply(pt, ts, tq, torch.from_numpy(x), False)
    assert objs == [None, None]
    for h, p in zip(heads, yolo_p):
        bs, ny, nx, _ = h.shape
        assert torch.equal(h.reshape(bs, ny, nx, 3, 7).permute(0, 3, 1, 2, 4),
                           p)
