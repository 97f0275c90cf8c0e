"""The QAT sim's bf16 eval snap (``fq(snap_dtype=...)``,
``make_quant_apply(eval_snap_dtype=...)``, ``prepare_eval_params``,
``load_model(eval_snap_dtype=...)`` and ``python -m yolo_tpu_torch.test
--qat-eval-snap bf16``) and the standalone [batchnorm] layer in the sim and
the int8 engine, against the JAX package, on the CPU.

``fq`` is compared with JAX's run eagerly (op by op), bit for bit: each
bf16 operation rounds as the port's does. The sims run jitted, as the
JAX package runs them (XLA may keep excess precision between fused bf16
operations, within the io bounds below). The sims' io is compared
as ``tests/test_torch_quant.py`` compares it: an activation on a
requantization boundary can round one quantum apart where the f32 convs
sum in other orders, so at most 0.1% of values may differ beyond rtol /
atol 1e-4, by under 0.05 in a score and 2 px in a box.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEAKY_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky')
# the tiny maxpool (layer 9) swapped for a standalone [batchnorm]: the
# layer indices, and so the routes, stay as they are
BN_CFG = LEAKY_CFG.replace('[maxpool]\nsize=2\nstride=1\n', '[BatchNorm2d]\n')
assert BN_CFG != LEAKY_CFG


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old = (torch.get_num_threads(), jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old[0])
    jax.config.update('jax_default_matmul_precision', old[1])


def _cfg(tmp_path_factory, name, text):
    p = tmp_path_factory.mktemp('snap') / f'{name}.cfg'
    p.write_text(text)
    return str(p)


def _assert_io_close(io_t, io_j):
    assert io_t.shape == io_j.shape and np.isfinite(io_t).all()
    off = np.abs(io_t - io_j) > 1e-4 + 1e-4 * np.abs(io_j)
    assert off.mean() < 1e-3, off.sum()
    assert np.abs(io_t[..., 4:] - io_j[..., 4:]).max() < 0.05
    assert np.abs(io_t[..., :4] - io_j[..., :4]).max() < 2.0


@pytest.mark.parametrize('bits,zp', [(8, 0.0), (8, 3.0), (4, 0.0)])
def test_fq_snap_bf16_bit_equal(bits, zp):
    """The bf16 chain (scale and zero point cast to bf16 too) returns
    ``dq`` with JAX's bits, within one quantization step plus a bf16
    rounding of the f32 chain's value (the bf16 scale moves the grid by
    ~2^-9, and the product rounds to 8 mantissa bits)."""
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu_torch.compress import quant as TQ
    rng = np.random.default_rng(bits + int(zp))
    x = rng.normal(0, 0.3, 8192).astype(np.float32)
    scale = np.float32(2.0 ** -1 / 127)
    want = np.asarray(JQ.fq(jnp.asarray(x), jnp.asarray(scale), zp, bits,
                            snap_dtype=jnp.bfloat16))
    got = TQ.fq(torch.from_numpy(x), torch.tensor(scale), zp, bits,
                snap_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32
    f32 = TQ.fq(torch.from_numpy(x), torch.tensor(scale), zp, bits).numpy()
    d = np.abs(got.numpy() - f32)
    assert np.all(d <= scale + 2.0 ** -8 * np.abs(f32)) and d.max() > 0


def _calibrated_port(cfg, steps=2, bs=2):
    """The port's sim, 2 calibration steps from seeded JAX-layout weights."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    net = build_ir(cfg)
    pj, sj = random_jax_weights(net, seed=0, conv_scale=1.0)
    pt, st = from_jax(net, pj, sj)
    qcfg = TQ.QuantConfig(steps=100)
    qs = TQ.init_quant_state(net, qcfg)[0]
    x = images(2, bs, 64).astype(np.float32) / 256.0
    apply = TQ.make_quant_apply(net, qcfg)
    for _ in range(steps):
        _, st, qs = apply(pt, st, qs, torch.from_numpy(x), True)
    return net, qcfg, pt, st, qs, x


@pytest.mark.parametrize('which', ['toy', 'yolov3-tiny'])
def test_eval_snap_sim_matches_jax(which, tmp_path_factory):
    """The eval sim with ``eval_snap_dtype`` bf16 on one calibrated state,
    against JAX's ``make_quant_apply(eval_snap_dtype=jnp.bfloat16)``; the
    port's ``prepare_eval_params`` path gives the unprepared floats bit for
    bit, with and without the snap."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import qstate_to_jax, to_jax
    cfg = (_cfg(tmp_path_factory, 'toy', TOY_CFG) if which == 'toy'
           else os.path.join(ROOT, 'cfg/yolov3tiny/yolov3-tiny.cfg'))
    net, qcfg, pt, st, qs, x = _calibrated_port(cfg)
    snap = TQ.make_quant_apply(net, qcfg, eval_snap_dtype=torch.bfloat16)
    assert snap.eval_snap_dtype is torch.bfloat16
    xt = torch.from_numpy(x)
    with torch.no_grad():
        io_t = snap(pt, st, qs, xt, False)[0]
        prepared = TQ.prepare_eval_params(net, qcfg, pt, st, qs)
        assert all('qw' in prepared[str(l.index)] for l in net.layers
                   if l.kind == 'conv')
        assert torch.equal(snap(prepared, st, qs, xt, False)[0], io_t)
        plain = TQ.make_quant_apply(net, qcfg)
        io_f = plain(pt, st, qs, xt, False)[0]
        assert torch.equal(plain(prepared, st, qs, xt, False)[0], io_f)
    assert not torch.equal(io_t, io_f)        # the snap moved something
    jp, js = to_jax(net, pt, st)
    jq = qstate_to_jax(qs)
    japply = JQ.make_quant_apply(jbuild(cfg), JQ.QuantConfig(steps=100),
                                 compute_dtype=None,
                                 eval_snap_dtype=jnp.bfloat16)
    io_j = np.asarray(jax.jit(japply, static_argnums=4)(
        jp, js, jq, jnp.asarray(x), False)[0])
    _assert_io_close(io_t.numpy(), io_j)


def test_qat_eval_snap_cli_runs(tmp_path):
    """``python -m yolo_tpu_torch.test --quantized 1 --qat-eval-snap bf16``
    evaluates a calibrated checkpoint (``load_model(eval_snap_dtype=
    torch.bfloat16)``) to finite results, as the f32 snap does."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch import test as cli
    from yolo_tpu_torch.convert import qstate_to_jax, to_jax
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    from test_torch_augment import write_jpeg_set
    cfg = str(tmp_path / 'leaky.cfg')
    (tmp_path / 'leaky.cfg').write_text(LEAKY_CFG)
    lst = write_jpeg_set(str(tmp_path), n=4, nc=2, seed=1)
    (tmp_path / 'names').write_text('a\nb\n')
    data = str(tmp_path / 'set.data')
    (tmp_path / 'set.data').write_text(
        f'classes=2\nvalid={lst}\nnames={tmp_path}/names\n')
    b = trt.load_model(cfg, device='cpu', quantized=1, steps=100,
                       eval_snap_dtype=torch.bfloat16)
    assert b.eval_snap_dtype is torch.bfloat16
    assert b.quant_apply().eval_snap_dtype is torch.bfloat16
    b.apply(trt.preprocess(images(3, 2, 64), device='cpu'), train=True)
    npz = str(tmp_path / 'q.npz')
    jp, js = to_jax(b.net, b.params, b.state)
    save_checkpoint(npz, params=jp, state=js, qstate=qstate_to_jax(b.qstate))
    base = ['--cfg', cfg, '--data', data, '--weights', npz, '--device', 'cpu',
            '--quantized', '1', '--img-size', '64', '--batch-size', '2',
            '--no-plot']
    r16 = cli.main(base + ['--qat-eval-snap', 'bf16'])
    r32 = cli.main(base)
    assert len(r16) == len(r32) == 7 and np.isfinite(r16).all()
    assert trt.load_model(cfg, npz, device='cpu').eval_snap_dtype is None


def test_lone_batchnorm_in_sim_and_engine_matches_jax(tmp_path_factory):
    """A standalone [batchnorm] in the sim: its batch-statistics train mode
    (the new running mean and var, momentum 0.03) and its eval mode against
    JAX's sim on one calibration; then the int8 engine's float BN edge
    (the conv after it on a float edge) against JAX's ``backend='xla'``
    engine on the same calibrated state: heads within 2 quanta."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu.models.int8_engine import make_int8_apply as jmake
    from yolo_tpu.models.int8_engine import prepare_int8 as jprepare
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import (from_jax, qstate_from_jax,
                                        qstate_to_jax, to_jax)
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.int8_engine import make_int8_apply, prepare_int8
    from yolo_tpu_torch.ops.conv_int8 import float_edge_conv
    cfg = _cfg(tmp_path_factory, 'bn', BN_CFG)
    net, jnet = build_ir(cfg), jbuild(cfg)
    assert net.layers[9].kind == 'batchnorm'
    TQ.check_supported(net, 'google')
    pj, sj = random_jax_weights(jnet, seed=0, conv_scale=1.0)
    x = images(2, 2, 64).astype(np.float32) / 256.0
    jcfg, tcfg = JQ.QuantConfig(steps=100), TQ.QuantConfig(steps=100)
    japply = JQ.make_quant_apply(jnet, jcfg, compute_dtype=None)
    tapply = TQ.make_quant_apply(net, tcfg)
    pt, st = from_jax(net, pj, sj)
    qs = TQ.init_quant_state(net, tcfg)[0]
    with torch.no_grad():
        _, st1, qs1 = tapply(pt, st, qs, torch.from_numpy(x), True)
    # one train step of each from the same state: the lone BN's new stats
    jit = jax.jit(japply, static_argnums=4)
    _, js1, _ = jit(pj, sj, qstate_to_jax(qs), jnp.asarray(x), True)
    for f in ('mean', 'var'):
        np.testing.assert_allclose(st1['9'][f].numpy(),
                                   np.asarray(js1['9'][f]), rtol=1e-5,
                                   atol=1e-6)
    # the eval sim from the port's calibrated state
    jp, js = to_jax(net, pt, st1)
    jq = qstate_to_jax(qs1)
    with torch.no_grad():
        io_t = tapply(pt, st1, qs1, torch.from_numpy(x), False)[0].numpy()
    io_j = np.asarray(jit(jp, js, jq, jnp.asarray(x), False)[0])
    _assert_io_close(io_t, io_j)
    # the engine: the conv after the BN runs on a float edge
    jplan = jprepare(jnet, jp, js, jq, jcfg)
    pt2, st2 = from_jax(net, jp, js)
    plan = prepare_int8(net, pt2, st2, qstate_from_jax(jq), tcfg,
                        device='cpu')
    assert set(plan.arrays['9']) == {'gamma', 'beta', 'mean', 'var'}
    hj, _ = jax.jit(jmake(jnet, jplan, backend='xla', heads_only=True))(
        jplan.arrays, jnp.asarray(x))
    f0 = float_edge_conv.calls
    ht, _ = make_int8_apply(net, plan, heads_only=True)(plan.arrays,
                                                        torch.from_numpy(x))
    assert float_edge_conv.calls - f0 == 2     # the stem and the conv at 11
    for a, b in zip(hj, ht):
        d = np.abs(np.asarray(a).astype(np.int32) - b.numpy().astype(np.int32))
        assert (d > 0).mean() <= 0.01 and d.max() <= 2, ((d > 0).sum(),
                                                          d.max())
