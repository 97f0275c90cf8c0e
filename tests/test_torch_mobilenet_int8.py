"""The QAT sim and the int8 engine of the port on a cfg with depthwise
convs and SE blocks (yolov3tiny-mobilenet-small-visdrone, 96 px), and on
a quantized reorg3d cfg (yolov3-spp-pan-scale), against the JAX package on
the CPU.

Weights come from ``random_jax_weights`` (numpy, seeded); the input is an
image batch / 256, as ``preprocess`` makes it. JAX runs its sim jitted, at
'highest' matmul precision.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import images, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MOBILE = os.path.join(ROOT, 'cfg', 'yolov3tiny-mobilenet-small',
                      'yolov3tiny-mobilenet-small-visdrone.cfg')
PAN = os.path.join(ROOT, 'cfg', 'yolov3', 'yolov3-spp-pan-scale.cfg')
SIZE = 96
STEPS = 3


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    old_prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    jax.config.update('jax_default_matmul_precision', old_prec)
    torch.set_num_threads(old_threads)


@pytest.fixture(scope='module')
def calibrated():
    """Both sims calibrated by STEPS train-mode steps from the same weights
    and images: (JAX net, JAX cfg, params, JAX state, JAX qstate, port
    state, port qstate, x)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax
    net = build_ir(MOBILE)
    pj, sj = random_jax_weights(net, seed=0, conv_scale=1.0)
    x = images(2, 2, SIZE).astype(np.float32) / 256.0
    jcfg = JQ.QuantConfig(steps=100)
    japply = JQ.make_quant_apply(net, jcfg, compute_dtype=None)
    step = jax.jit(lambda p, s, q, x: japply(p, s, q, x, True)[1:])
    tcfg = TQ.QuantConfig(steps=100)
    tapply = TQ.make_quant_apply(net, tcfg)
    js, jq = sj, JQ.init_quant_state(net, jcfg)[0]
    pt, ts = from_jax(net, pj, sj)
    tq = TQ.init_quant_state(net, tcfg)[0]
    for _ in range(STEPS):
        js, jq = step(pj, js, jq, jnp.asarray(x))
        _, ts, tq = tapply(pt, ts, tq, torch.from_numpy(x), True)
    return net, jcfg, pj, js, jq, ts, tq, x


def test_mobilenet_calibration_matches_jax(calibrated):
    """Every quantizer scale and zero point, every step counter and first
    flag equal to JAX's after 3 steps (the scales are pow-2 snapped, so
    they are what the engine runs on); the tracker ranges and BN running
    statistics close. Not equal: the SE blocks are float edges into the
    next conv's quantizers, so the two frameworks' float sums can round an
    activation on a requantization boundary one quantum apart, and at 96
    px the deep BN statistics are over 18-72 values per channel, where one
    quantum moves them by up to about 1%."""
    from yolo_tpu_torch.convert import qstate_to_jax
    net, _, _, js, jq, ts, tq, _ = calibrated
    tqj = qstate_to_jax(tq)
    assert tqj.keys() == jq.keys()
    n_scales = 0
    for k, d in jq.items():
        assert tqj[k].keys() == d.keys(), k
        for f, v in d.items():
            if not isinstance(v, dict):
                if f in ('scale', 'input_scale', 'first_bn', 'step'):
                    assert float(tqj[k][f]) == float(v), (k, f)
                else:                               # a concat's |max| list
                    np.testing.assert_allclose(tqj[k][f], v, rtol=2e-2)
                continue
            for g in ('scale', 'zp', 'first', 'step'):
                assert float(tqj[k][f][g]) == float(v[g]), (k, f, g)
            span = float(v['max']) - float(v['min'])
            for g in ('min', 'max'):
                assert abs(float(tqj[k][f][g]) - float(v[g])) <= 2e-2 * span, (
                    k, f, g)
            n_scales += 1
    assert n_scales == 3 * sum(l.kind in ('conv', 'depthwise')
                               for l in net.layers) + 3 * 6
    assert js.keys() == ts.keys()
    for k in js:
        std = np.sqrt(np.asarray(js[k]['var']))
        np.testing.assert_allclose(ts[k]['mean'].numpy(),
                                   np.asarray(js[k]['mean']), rtol=1e-5,
                                   atol=0.02 * std.max())
        np.testing.assert_allclose(ts[k]['var'].numpy(),
                                   np.asarray(js[k]['var']), rtol=2e-2)


def _port_side(calibrated):
    """The port's net, weights and qstate from JAX's calibration."""
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    from yolo_tpu_torch.ir import build_ir
    _, _, pj, js, jq, _, _, _ = calibrated
    net = build_ir(MOBILE)
    pt, st = from_jax(net, pj, js)
    return net, pt, st, qstate_from_jax(jq)


def test_mobilenet_sim_eval_matches_jax(calibrated):
    """The eval sim on JAX's calibrated weights and qstate: io within
    rtol/atol 1e-4 of JAX's, SE, depthwise convs and all."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    jnet, jcfg, pj, js, jq, _, _, x = calibrated
    japply = JQ.make_quant_apply(jnet, jcfg, compute_dtype=None)
    io_j = np.asarray(jax.jit(lambda *a: japply(*a, False)[0])(
        pj, js, jq, jnp.asarray(x)))
    net, pt, st, qs = _port_side(calibrated)
    io_t, yolo_p, _ = TQ.make_quant_apply(net, TQ.QuantConfig(steps=100))(
        pt, st, qs, torch.from_numpy(x), False)
    assert io_t.shape == io_j.shape == (2, 3 * (9 + 36), 15)
    np.testing.assert_allclose(io_t.numpy(), io_j, rtol=1e-4, atol=1e-4)


def _plans(calibrated):
    from yolo_tpu.models.int8_engine import prepare_int8 as jprepare
    from yolo_tpu_torch.compress.quant import QuantConfig
    from yolo_tpu_torch.models.int8_engine import prepare_int8
    jnet, jcfg, pj, js, jq, _, _, _ = calibrated
    net, pt, st, qs = _port_side(calibrated)
    return (jnet, jprepare(jnet, pj, js, jq, jcfg),
            net, prepare_int8(net, pt, st, qs, QuantConfig(steps=100),
                              device='cpu'))


def test_mobilenet_prepare_int8_matches_jax(calibrated):
    """int8 weights of every conv, depthwise ones included ((Cout, K, K,
    Cin / groups) here, HWIO there), the dequantized biases and the SE fc
    weights array-equal; every meta scale equal."""
    _, jplan, net, plan = _plans(calibrated)
    assert jplan.arrays.keys() == plan.arrays.keys()
    n = {'w8': 0, 'fc1': 0}
    for k, v in jplan.arrays.items():
        got = plan.arrays[k]
        assert got.keys() == v.keys(), k
        for f, a in v.items():
            want = np.asarray(a)
            if f == 'w8':
                want = want.transpose(3, 0, 1, 2)
                assert got[f].dtype == torch.int8 and got[f].is_contiguous()
            np.testing.assert_array_equal(got[f].numpy(), want)
            n[f] = n.get(f, 0) + 1
    assert n['w8'] == 41 and n['fc1'] == 9
    assert plan.meta == jplan.meta


def test_mobilenet_engine_matches_jax_xla_engine(calibrated):
    """The engine's int8 heads against JAX's bit-faithful ``backend='xla'``
    engine, to the standard of ``test_engine_matches_jax_xla_engine`` for
    deep nets: at most 1% of the head values apart, by at most 2 LSB (the
    SE means and fcs are float sums in both frameworks). The convs take
    their three routes: K2 (its plain twin here) for the ungrouped 1x1 and
    3x3 convs on int8 edges, the exact grouped int32 conv for the 11
    depthwise convs, and the float-edge conv for the stem and the 9 convs
    after an SE block."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.models.int8_engine import make_int8_apply as jmake
    from yolo_tpu_torch.models.int8_engine import make_int8_apply
    from yolo_tpu_torch.ops.conv_int8 import (float_edge_conv, fused_conv_int8,
                                              grouped_conv_int8)
    jnet, jplan, net, plan = _plans(calibrated)
    x = calibrated[-1]
    jheads = jmake(jnet, jplan, backend='xla', heads_only=True)
    k2_calls = []

    def k2(*args, **kw):
        k2_calls.append(args[1].shape)
        return fused_conv_int8(*args, **kw)
    heads = make_int8_apply(net, plan, heads_only=True, conv=k2)
    assert heads.head_scales == jheads.head_scales
    hj, oj = jax.jit(jheads)(jplan.arrays, jnp.asarray(x))
    g0, f0 = grouped_conv_int8.calls, float_edge_conv.calls
    ht, ot = heads(plan.arrays, torch.from_numpy(x))
    assert grouped_conv_int8.calls - g0 == 11
    assert float_edge_conv.calls - f0 == 10
    assert len(k2_calls) == 41 - 11 - 10
    for a, b, oa, ob, sa in zip(hj, ht, oj, ot, heads.head_scales):
        a, b = np.asarray(a), b.numpy()
        assert b.dtype == np.int8 and a.shape == b.shape
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert (d > 0).mean() <= 0.01 and d.max() <= 2, ((d > 0).sum(),
                                                         d.max())
        assert np.abs(b).max() > 30                  # not a dead head
        np.testing.assert_allclose(ob.numpy(), np.asarray(oa), rtol=0,
                                   atol=2 * sa)


def test_quantized_reorg3d_cfg_loads_and_matches_jax_sim():
    """``load_model(yolov3-spp-pan-scale, quantized=1)`` builds (its float
    init runs reorg3d); after one calibration step in the port, JAX's sim on
    the port's weights and qstate gives the port's eval io within
    rtol/atol 1e-4. JAX's sim runs op by op here, as in
    ``tests/test_torch_quant.py``: jitted, XLA's fusions move one
    activation of layer 29 across a requantization boundary against its
    own op-by-op result, and the quantum carries down the net."""
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import qstate_to_jax, to_jax
    b = trt.load_model(PAN, device='cpu', quantized=1, steps=100,
                       generator=torch.Generator().manual_seed(0))
    assert sum(l.kind == 'reorg3d' for l in b.net.layers) == 4
    x = trt.preprocess(images(4, 1, 64), device='cpu')
    b.apply(x, train=True)
    io_t = b.apply(x)[0].numpy()
    jnet = build_ir(PAN)
    pj, sj = to_jax(b.net, b.params, b.state)
    io_j = np.asarray(JQ.make_quant_apply(
        jnet, JQ.QuantConfig(steps=100), compute_dtype=None)(
        pj, sj, qstate_to_jax(b.qstate), jnp.asarray(x.numpy()), False)[0])
    assert io_t.shape == io_j.shape and np.isfinite(io_t).all()
    np.testing.assert_allclose(io_t, io_j, rtol=1e-4, atol=1e-4)
