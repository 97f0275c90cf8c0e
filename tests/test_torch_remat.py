"""The port's remat policies (``make_train_functions(remat=...)``:
``Darknet.forward_train``'s segments between block boundaries under
``torch.utils.checkpoint``, the whole forward, the whole quant apply)
against the step without remat and against JAX's ``remat='blocks'``, on
the CPU.

- On JAX's ``RESIDUAL_CFG`` (``tests/test_trainer.py``: a shortcut and a
  multi-route, both block boundaries) 'blocks' and 'full' against no
  remat: the loss items within rtol 1e-6, the gradients within rtol 1e-5
  / atol 1e-7 (JAX's own test of its policy), the new BN running
  statistics bit-equal (the update applied once, not again by the
  recompute).
- 'blocks' on ``TOY_CFG`` against JAX's ``remat='blocks'``, by the
  training tolerances of ``test_torch_train_step.py`` (1e-4).
- A google QAT step on ``PLAIN_CFG`` with 'blocks' (the whole quant apply
  recomputed) against none: the trackers, the step counts and the BN
  statistics equal, the gradients within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights
from test_torch_parallel import PLAIN_CFG
from test_torch_train_step import _close_to_norm, toy_targets

NC = 2


@pytest.fixture(scope='module', autouse=True)
def _precision():
    import jax
    prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jax.config.update('jax_default_matmul_precision', prec)
    torch.set_num_threads(threads)


def build(tmp_path, text, name):
    from yolo_tpu_torch.ir import build_ir
    p = tmp_path / f'{name}.cfg'
    p.write_text(text)
    return str(p), build_ir(str(p))


def batch(seed=11, bs=2, size=64):
    x = images(seed, bs, size).astype(np.float32) / 256.0
    tgt, valid = toy_targets(seed + 1, bs)
    return x, tgt, valid


def port_grads(net, pj, sj, remat, quant=None, hyp=None):
    """One f32 ``grad_fn`` of the port: (items, {key: grad}, {key: new BN
    state}, flat quantizer state)."""
    from yolo_tpu_torch.convert import from_jax, qstate_to_jax
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    avecs = [np.asarray(l.anchors) / l.yolo_stride for l in net.layers
             if l.kind == 'yolo']
    kw, qstate = {}, None
    if quant is not None:
        kw['quant_apply'], qstate = quant
    grad_fn, _ = make_train_functions(net, avecs, NC, hyp or LossHyp(),
                                      remat=remat, **kw)
    ts = init_train_state(net, *from_jax(net, pj, sj), compute_dtype=None,
                          device='cpu', qstate=qstate)
    x, tgt, valid = batch()
    ts, items = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(tgt),
                        torch.from_numpy(valid), 1.0, 0.5)
    grads = {f'{k}.{f}': p.grad.numpy().copy() for k, d in ts.params.items()
             for f, p in d.items()}
    bn = {f'{k}.{f}': t.numpy().copy() for k, d in ts.bn_state.items()
          for f, t in d.items()}
    q = {}
    if ts.qstate is not None:
        from test_torch_parallel import flat
        q = flat(qstate_to_jax(ts.qstate), 'q')
    return items.numpy(), grads, bn, q


@pytest.mark.parametrize('remat', ['blocks', 'full'])
def test_remat_matches_no_remat(remat, tmp_path):
    """'blocks' and 'full' on ``RESIDUAL_CFG`` change what the backward
    keeps, not what it computes."""
    from test_trainer import RESIDUAL_CFG
    _, net = build(tmp_path, RESIDUAL_CFG, 'res')
    pj, sj = random_jax_weights(net, seed=0, conv_scale=0.7)
    items0, g0, bn0, _ = port_grads(net, pj, sj, None)
    items, g, bn, _ = port_grads(net, pj, sj, remat)
    np.testing.assert_allclose(items, items0, rtol=1e-6)
    assert g.keys() == g0.keys()
    for k in g0:
        np.testing.assert_allclose(g[k], g0[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert bn.keys() == bn0.keys() and bn0
    for k in bn0:
        np.testing.assert_array_equal(bn[k], bn0[k], err_msg=k)
        assert not np.array_equal(bn[k], sj[k.split('.')[0]][k.split('.')[1]])


def test_remat_blocks_matches_jax(tmp_path):
    """The port's 'blocks' on ``TOY_CFG`` against JAX's ``remat='blocks'``:
    loss items rtol 1e-4, gradients within 1e-4 of each tensor's largest
    value, the new BN statistics rtol 1e-4 / atol 1e-5."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.trainer import init_train_state as jinit
    from yolo_tpu.train.trainer import make_train_functions as jmake
    from yolo_tpu_torch.config import DEFAULT_HYP
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.train.loss import LossHyp
    path, net = build(tmp_path, TOY_CFG, 'toy')
    jnet = jbuild(path)
    pj, sj = random_jax_weights(net, seed=9, conv_scale=0.7)
    avecs = [np.asarray(l.anchors) / l.yolo_stride for l in net.layers
             if l.kind == 'yolo']
    jgrad, _ = jmake(jnet, avecs, NC, JHyp.from_dict(DEFAULT_HYP, nc=NC),
                     compute_dtype=None, remat='blocks')
    jst = jinit(jax.tree.map(jnp.asarray, pj), jax.tree.map(jnp.asarray, sj))
    x, tgt, valid = batch()
    jst, jitems = jgrad(jst, jnp.asarray(x), jnp.asarray(tgt),
                        jnp.asarray(valid), 1.0, 0.5)
    items, g, bn, _ = port_grads(net, pj, sj, 'blocks',
                                 hyp=LossHyp.from_dict(DEFAULT_HYP, nc=NC))
    np.testing.assert_allclose(items, np.asarray(jitems), rtol=1e-4)
    jg, _ = from_jax(net, jax.device_get(jst.grad_accum), {})
    for k, d in jg.items():
        for f, t in d.items():
            _close_to_norm(g[f'{k}.{f}'], t.numpy(), 1e-4, f'{k}.{f}')
    for k, d in jst.bn_state.items():
        for f in ('mean', 'var'):
            np.testing.assert_allclose(bn[f'{k}.{f}'], np.asarray(d[f]),
                                       rtol=1e-4, atol=1e-5)


def test_qat_remat_applies_trackers_once(tmp_path):
    """A google QAT step with 'blocks' recomputes the whole quant apply in
    the backward: the range trackers, step counts and BN statistics are
    the first forward's (equal to the step without remat), the gradients
    within rtol 1e-5 / atol 1e-7."""
    from yolo_tpu_torch.compress import quant as TQ
    _, net = build(tmp_path, PLAIN_CFG, 'plain')
    pj, sj = random_jax_weights(net, seed=9, conv_scale=0.7)
    qcfg = TQ.QuantConfig(scheme='google', steps=10)

    def quant():
        return (TQ.make_quant_apply(net, qcfg, head_layout='nhwc'),
                TQ.init_quant_state(net, qcfg)[0])
    items0, g0, bn0, q0 = port_grads(net, pj, sj, None, quant())
    items, g, bn, q = port_grads(net, pj, sj, 'blocks', quant())
    np.testing.assert_allclose(items, items0, rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(g[k], g0[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert q.keys() == q0.keys() and any('step' in k for k in q0)
    for tree, tree0 in ((bn, bn0), (q, q0)):
        for k in tree0:
            np.testing.assert_array_equal(tree[k], tree0[k], err_msg=k)
    # each conv's activation tracker has counted one step, not two
    steps = [int(v) for k, v in q.items() if k.endswith('/aq/step')]
    assert steps and all(v == 1 for v in steps), steps
