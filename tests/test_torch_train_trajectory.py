"""Eight f32 train steps of the port (``grad_fn`` + ``update_fn`` on the
burn-in scalars and the ``ni % accumulate`` cadence) against the JAX
trainer on ``TOY_CFG`` at 64 px, for SGD and for Adam, on the CPU.

The burn-in is 6 batches at a nominal batch size of 32, so ``accumulate``
ramps from 1 to 2 and the optimizer steps at ni = 0, 1, 2, 4 and 6, the
giou ratio ramps from 0 to 1 and the BN running statistics move at every
batch. After the last step the params, the BN state and the EMA pair are
compared by how far they moved: per param group (weight, bias, other) or
BN field, ||port - JAX|| / ||JAX - start||, so that a group whose lr is
small (Adam's weight group moves 7e-3 in all under this burn-in) is held
as tightly as one whose lr is large. The optimizer state starts at zero and is compared
per tensor within ``TOL`` of its largest magnitude; the EMA counter
exactly. f32 only: the JAX package's bf16 objectness scatter has no
defined winner at a shared cell.

The tolerances are about three times the largest error measured. The
gradients agree to ~1e-5 of their norm (the convs' summation orders); SGD
keeps that in the params' moves (6.9e-5 of the weight group's, 5.2e-5 of
the other group's), while its momentum buffers, sums of gradients that
partly cancel, keep 7.3e-4. Adam divides each element by its own gradient
scale, so elements whose gradients are near zero take steps of either
sign: 7.3e-4 of the bias group's move, 5.1e-4 of the weight group's
(1.7e-3 in the moments).
"""

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights
from test_torch_train_step import _close_to_norm, toy_targets

TOL = {'sgd': dict(params=2e-4, bn_state=1e-5, ema=2e-4, ema_state=3e-6,
                  momentum_buf=2e-3),
       'adam': dict(params=2e-3, bn_state=2e-5, ema=2e-3, ema_state=1.5e-5,
                    m=5e-3, v=6e-3)}
N_STEPS, N_BURN, NOMINAL_BS, BS = 8, 6, 32, 4


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old = (torch.get_num_threads(), jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old[0])
    jax.config.update('jax_default_matmul_precision', old[1])


@pytest.mark.parametrize('optimizer', ['sgd', 'adam'])
def test_eight_step_trajectory_matches_jax(optimizer, tmp_path):
    import jax
    import jax.numpy as jnp
    from yolo_tpu.ir import build_ir
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.schedules import burn_in_scalars as jburn
    from yolo_tpu.train.trainer import init_train_state as jinit
    from yolo_tpu.train.trainer import make_train_functions as jmake
    from yolo_tpu_torch.config import DEFAULT_HYP
    from yolo_tpu_torch.convert import from_jax, opt_state_from_jax
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.optim import group_label
    from yolo_tpu_torch.train.schedules import burn_in_scalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    cfg = tmp_path / 'toy.cfg'
    cfg.write_text(TOY_CFG)
    net = build_ir(str(cfg))
    pj, sj = random_jax_weights(net, seed=21, conv_scale=0.7)
    avecs = [np.asarray(l.anchors) / l.yolo_stride
             for l in net.layers if l.kind == 'yolo']
    adam = optimizer == 'adam'
    hyp = dict(DEFAULT_HYP, lr0=0.01)
    jgrad, jupdate = jmake(net, avecs, 2, JHyp.from_dict(hyp, nc=2),
                           optimizer=optimizer, compute_dtype=None)
    jst = jinit(jax.tree.map(jnp.asarray, pj), jax.tree.map(jnp.asarray, sj),
                optimizer=optimizer)
    grad_fn, update_fn = make_train_functions(net, avecs, 2,
                                              LossHyp.from_dict(hyp, nc=2))
    pt, st = from_jax(net, pj, sj)
    ts = init_train_state(net, pt, st, optimizer=optimizer,
                          compute_dtype=None, device='cpu')
    updates = []
    for ni in range(N_STEPS):
        kw = dict(lr0=hyp['lr0'], momentum=hyp['momentum'],
                  weight_decay=hyp['weight_decay'], epochs=3,
                  batch_size=NOMINAL_BS, adam=adam)
        jsc, gr, acc = jburn(ni, N_BURN, ni // 4, **kw)
        sc, gr_t, acc_t = burn_in_scalars(ni, N_BURN, ni // 4, **kw)
        assert (gr, acc) == (gr_t, acc_t)
        x = images(100 + ni, BS, 64).astype(np.float32) / 256.0
        tgt, valid = toy_targets(200 + ni, BS)
        ls = NOMINAL_BS / 64.0
        jst, _ = jgrad(jst, jnp.asarray(x), jnp.asarray(tgt),
                       jnp.asarray(valid), gr, ls)
        ts, _ = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(tgt),
                        torch.from_numpy(valid), gr, ls)
        if ni % acc == 0:
            jst = jupdate(jst, jsc)
            ts = update_fn(ts, sc)
            updates.append(ni)
    assert updates == [0, 1, 2, 4, 6]
    jst = jax.device_get(jst)

    tol = TOL[optimizer]
    want0 = from_jax(net, pj, sj)

    def compare(tree, jtree, tree0, what):
        """How far the port moved against how far JAX moved, per group:
        ||(p_T - p_0) - (q_T - p_0)|| / ||q_T - p_0|| over the group."""
        want = from_jax(net, jtree, {})[0]
        diff, norm = {}, {}
        for k, d in want.items():
            for f, w in d.items():
                g = group_label(k, f) if what in ('params', 'ema') else f
                step = w.double() - tree0[k][f].double()
                err = tree[k][f].detach().double() - w.double()
                diff[g] = diff.get(g, 0.0) + float(err.square().sum())
                norm[g] = norm.get(g, 0.0) + float(step.square().sum())
        for g in diff:
            rel = (diff[g] / norm[g]) ** 0.5
            assert norm[g] > 0, f'{what} group {g} did not move'
            assert rel <= tol[what], f'{what} group {g}: {rel} > {tol[what]}'
    compare(ts.params, jst.params, want0[0], 'params')
    compare(ts.bn_state, jst.bn_state, want0[1], 'bn_state')
    compare(ts.ema.params, jst.ema.params, want0[0], 'ema')
    compare(ts.ema.state, jst.ema.state, want0[1], 'ema_state')
    assert int(ts.ema.updates) == int(jst.ema.updates) == 5
    want = opt_state_from_jax(net, jst.opt_state)
    got = ts.opt_state
    if adam:
        assert int(got['step']) == want['step'] == 5
    for name in want:
        if name == 'step':
            continue
        for k, d in want[name].items():
            for f, w in d.items():
                _close_to_norm(got[name][k][f].numpy(), w.numpy(),
                               tol[name], f'{name} {k}.{f}')
