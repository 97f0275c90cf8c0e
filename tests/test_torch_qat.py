"""QAT in the port (``make_train_functions(quant_apply=...)``, the QAT path
of ``run_training`` and the train CLI's ``--quantized``) against the JAX
package, on the CPU, in f32 with JAX at 'highest' matmul precision.

- ``grad_fn``/``update_fn`` steps with Adam, google and TPSQ on
  ``LEAKY_CFG`` at 64 px. At every step the port's train forward and loss
  on JAX's own state agree within rtol 1e-5 (``STEP_TOL``). The two
  trajectories, each run on its own, keep the params per optimizer group
  within 1e-4 of their norm (``TRAJ_TOL``), every quantizer scale equal,
  the loss items within 1e-2 of the total and the BN state within 1e-3 of its
  norm (``DRIFT_TOL``): Adam's first steps move every element by about
  the lr whatever its gradient's size, so an element whose gradient is
  rounding noise moves by +lr in one package and -lr in the other, and a
  weight so moved across a quantization boundary changes the forward by a
  whole quantum (measured: the google loss 3.6e-3 apart after 3 steps,
  the params 1e-5 of their norm; on JAX's state the port's loss is 2e-7
  from JAX's at every step).
- ``run_training(quantized=1, qat_dtype='f32')`` of both packages on 16
  JPEG files for 2 epochs of 8 steps, so that the scale freeze (step 1)
  and the BN freeze (step 14) both fall inside, then a resume for a third
  epoch: the ``results.txt`` rows, ``qstate`` and the checkpointed params
  by the trajectory's bounds.

``LEAKY_CFG`` is ``TOY_CFG`` with its one mish conv made leaky: the two
frameworks' mish differ by ulps, and at the first step, with the BN fold on
batch statistics, one activation that lands a quantum apart moves the
statistics of every conv after it, which moves more values across their
rounding boundaries (17% of the heads a quantum apart at the first step
on the toy). With leaky and linear only, the train heads are bit-equal,
and the step's gradients agree to ~1e-6 of their norm (the BN statistics
convs sum in other orders); Adam divides each element by its own gradient
scale, so an element with a near-zero gradient moves by a full lr step of
either sign, which is why the params are held by their move and not by
the gradient's rounding.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights
from test_torch_augment import write_jpeg_set
from test_torch_train_step import _close_to_norm, toy_targets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# TOY_CFG with its one mish conv (layer 3) made leaky
LEAKY_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky')
assert LEAKY_CFG != TOY_CFG
N_STEPS, BS = 4, 2
# the port's loss items on JAX's state, rtol
STEP_TOL = 1e-5
# params: ||port - JAX|| / ||JAX|| per optimizer group
TRAJ_TOL = 1e-4
# a quant apply's gradient: of the whole gradient's norm, and of each
# tensor's largest magnitude
GRAD_TOL = 1e-4, 1e-2
# the free-running trajectories: loss items (rtol), BN state (of its norm)
# and tracker min/max (rtol)
DRIFT_TOL = 1e-2, 1e-3, 1e-3


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old = (torch.get_num_threads(), jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old[0])
    jax.config.update('jax_default_matmul_precision', old[1])


@pytest.fixture(scope='module')
def toy_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp('qatcfg') / 'leaky.cfg'
    p.write_text(LEAKY_CFG)
    return str(p)


def _params_close(tree, jtree, tree0, net, what):
    """Per optimizer group: ||port - JAX|| / ||JAX|| <= TRAJ_TOL, and
    every group moved from ``tree0``."""
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.train.optim import GROUP_NAMES, group_label
    want = from_jax(net, jtree, {})[0]
    diff, norm, move = {}, {}, {}
    for k, d in want.items():
        for f, w in d.items():
            g = GROUP_NAMES[group_label(k, f)]
            err = tree[k][f].detach().double() - w.double()
            diff[g] = diff.get(g, 0.0) + float(err.square().sum())
            norm[g] = norm.get(g, 0.0) + float(w.double().square().sum())
            move[g] = move.get(g, 0.0) + float(
                (w.double() - tree0[k][f].double()).square().sum())
    for g in diff:
        assert move[g] > 0, f'{what}: group {g} did not move'
        rel = (diff[g] / norm[g]) ** 0.5
        assert rel <= TRAJ_TOL, f'{what}: group {g}: {rel} > {TRAJ_TOL}'
    return set(diff)


def _grads_close(params, want):
    """The gradient in ``params[k][f].grad`` against ``want``: within
    GRAD_TOL[0] of the norm of the whole gradient, and each tensor within
    GRAD_TOL[1] of its own largest magnitude."""
    err = norm = 0.0
    for k, d in want.items():
        for f, w in d.items():
            g = params[k][f].grad
            assert g is not None, (k, f)
            err += float((g.double() - w.double()).square().sum())
            norm += float(w.double().square().sum())
            _close_to_norm(g.numpy(), w.numpy(), GRAD_TOL[1], f'grad {k}/{f}')
    assert (err / norm) ** 0.5 <= GRAD_TOL[0], ((err / norm) ** 0.5)


def _items_close(got, want, what):
    """Loss items [giou, obj, cls(, total)] within DRIFT_TOL[0] of their
    sum."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    total = want[-1] if len(want) == 4 else want.sum()
    assert err <= DRIFT_TOL[0] * abs(total), (what, got, want)


def _qstate_equal(got, want, rtol=1e-5):
    """Scales, votes and counters exactly; tracker min/max and a concat's
    |max| list within ``rtol`` (their inputs are sums in other orders).
    Returns the number of leaves compared."""
    from yolo_tpu_torch.convert import qstate_to_jax
    return _tree_equal(qstate_to_jax(got), want, '', rtol)


def _tree_equal(got, want, path, rtol):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        return sum(_tree_equal(got[k], v, f'{path}/{k}', rtol)
                   for k, v in want.items())
    if path.rsplit('/', 1)[-1] in ('min', 'max', 'float_max'):
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol,
                                   atol=1e-7, err_msg=path)
    else:
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=path)
    return 1


@pytest.mark.parametrize('scheme', ['google', 'tpsq'])
def test_qat_steps_match_jax(scheme, toy_cfg):
    """``N_STEPS`` QAT steps (Adam, the MultiStep lr) through both trainers
    from the same weights; the freeze steps fall inside (steps=10: the
    scale freeze at 1). TPSQ starts from the JAX warmup's scales."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.schedules import burn_in_scalars as jburn
    from yolo_tpu.train.trainer import init_train_state as jinit
    from yolo_tpu.train.trainer import make_train_functions as jmake
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.config import DEFAULT_HYP
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    from yolo_tpu_torch.train.loss import LossHyp, compute_loss
    from yolo_tpu_torch.train.schedules import burn_in_scalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    net = build_ir(toy_cfg)
    pj, sj = random_jax_weights(net, seed=21, conv_scale=0.7)
    jcfg = JQ.QuantConfig(scheme=scheme, steps=10)
    tcfg = TQ.QuantConfig(scheme=scheme, steps=10)
    jq, extra = JQ.init_quant_state(net, jcfg)
    for k, v in extra.items():
        pj[k] = {**pj[k], **{f: np.asarray(a) for f, a in v.items()}}
    if scheme == 'tpsq':
        x0 = images(99, BS, 64).astype(np.float32) / 256.0
        pj = jax.device_get(JQ.tpsq_warmup(net, jcfg, pj, sj, jq,
                                           jnp.asarray(x0)))
        pj = jax.tree.map(np.asarray, pj)
    avecs = [np.asarray(l.anchors) / l.yolo_stride
             for l in net.layers if l.kind == 'yolo']
    hyp = dict(DEFAULT_HYP, lr0=0.01)
    japply = JQ.make_quant_apply(net, jcfg, compute_dtype=jnp.float32,
                                 head_layout='nhwc')
    jgrad, jupdate = jmake(net, avecs, 2, JHyp.from_dict(hyp, nc=2),
                           optimizer='adam', quant_apply=japply)
    jst = jinit(jax.tree.map(jnp.asarray, pj), jax.tree.map(jnp.asarray, sj),
                optimizer='adam', qstate=jq)
    tapply = TQ.make_quant_apply(net, tcfg, head_layout='nhwc')
    grad_fn, update_fn = make_train_functions(
        net, avecs, 2, LossHyp.from_dict(hyp, nc=2), quant_apply=tapply)
    pt, st = from_jax(net, pj, sj)
    ts = init_train_state(net, pt, st, optimizer='adam', compute_dtype=None,
                          device='cpu', qstate=qstate_from_jax(
                              jax.tree.map(np.asarray, jq)))
    lhyp = LossHyp.from_dict(hyp, nc=2)
    tavecs = [torch.as_tensor(a, dtype=torch.float32) for a in avecs]
    for ni in range(N_STEPS):
        kw = dict(lr0=hyp['lr0'], momentum=hyp['momentum'],
                  weight_decay=hyp['weight_decay'], epochs=2,
                  batch_size=BS, quantized=True)
        jsc, gr, _ = jburn(ni, 0, ni // 2, **kw)
        sc, gr_t, _ = burn_in_scalars(ni, 0, ni // 2, **kw)
        assert gr == gr_t
        x = images(100 + ni, BS, 64).astype(np.float32) / 256.0
        tgt, valid = toy_targets(200 + ni, BS)
        # the port's forward and loss on JAX's state of this step
        js = jax.device_get(jst)
        p_j, s_j = from_jax(net, js.params, js.bn_state)
        with torch.no_grad():
            (yp, _), _, _ = tapply(p_j, s_j, qstate_from_jax(js.qstate),
                                   torch.from_numpy(x), True)
            on_j = compute_loss(yp, torch.from_numpy(tgt),
                                torch.from_numpy(valid), tavecs, 2, lhyp, gr,
                                layout='nhwc')[1]
        jst, jitems = jgrad(jst, jnp.asarray(x), jnp.asarray(tgt),
                            jnp.asarray(valid), gr, BS / 64.0)
        np.testing.assert_allclose(on_j.numpy(), np.asarray(jitems),
                                   rtol=STEP_TOL,
                                   err_msg=f'loss on JAX state, step {ni}')
        ts, items = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(tgt),
                            torch.from_numpy(valid), gr, BS / 64.0)
        _items_close(items.numpy(), np.asarray(jitems), f'step {ni}')
        jst = jupdate(jst, jsc)
        ts = update_fn(ts, sc)
    jst = jax.device_get(jst)
    assert _qstate_equal(ts.qstate, jst.qstate, DRIFT_TOL[2]) > 20
    assert all(float(v['step']) == N_STEPS for v in jst.qstate.values()
               if 'step' in v)
    bn = from_jax(net, {}, jst.bn_state)[1]
    for k, d in bn.items():
        for f, w in d.items():
            _close_to_norm(ts.bn_state[k][f].detach().numpy(), w.numpy(),
                           DRIFT_TOL[1], f'bn {k}/{f}')
    groups = _params_close(ts.params, jst.params, from_jax(net, pj, sj)[0],
                           net, scheme)
    assert ('scale' in groups) == (scheme == 'tpsq')   # TPSQ's scales train


def test_bn_frozen_train_step_matches_jax(toy_cfg):
    """Past ``bn_freeze_step`` the stat-conv-free apply of both packages,
    from the same calibrated state: the train heads within 1e-5 of their
    norm, the BN state left exactly where it was, the quantizer steps
    advanced, and the gradient of a loss on the heads by ``GRAD_TOL``; the
    full step from the same state (whose running statistics drift by 1%)
    within 1e-5 of JAX's full step."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    net = build_ir(toy_cfg)
    pj, sj = random_jax_weights(net, seed=2, conv_scale=1.0)
    jcfg, tcfg = JQ.QuantConfig(steps=10), TQ.QuantConfig(steps=10)
    jfull = JQ.make_quant_apply(net, jcfg, compute_dtype=None)
    x = jnp.asarray(images(3, 2, 64).astype(np.float32) / 256.0)
    st, qs = sj, JQ.init_quant_state(net, jcfg)[0]
    for _ in range(10):                        # past bn_freeze_step = 9
        _, st, qs = jfull(pj, st, qs, x, True)
    st, qs = jax.device_get(st), jax.device_get(qs)
    jfrozen = jfull.make_bn_frozen()
    tfull = TQ.make_quant_apply(net, tcfg)
    tfrozen = tfull.make_bn_frozen()
    pt, stt = from_jax(net, pj, st)
    pt = {k: {f: v.requires_grad_(True) for f, v in d.items()}
          for k, d in pt.items()}
    qt = qstate_from_jax(jax.tree.map(np.asarray, qs))

    def jloss(p):
        (yp, _), _, _ = jfrozen(p, st, qs, x, True)
        return sum(jnp.sum(jnp.tanh(o)) for o in yp)

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, pj))
    (yp_j, _), st_j, q_j = jfrozen(pj, st, qs, x, True)
    (yp_t, _), st_t, q_t = tfrozen(pt, stt, qt, torch.from_numpy(
        np.asarray(x)), True)
    sum(torch.sum(torch.tanh(o)) for o in yp_t).backward()
    for a, b in zip(yp_j, yp_t):
        _close_to_norm(b.detach().numpy(), np.asarray(a), 1e-5, 'heads')
    for k in st:
        for f in ('mean', 'var'):
            assert torch.equal(st_t[k][f], stt[k][f]), (k, f)
    for k, v in q_j.items():
        if 'step' in v:
            assert float(q_t[k]['step']) == float(v['step']) == 11
    _grads_close(pt, from_jax(net, jax.device_get(jg), {})[0])
    # the full step past the freeze: the running statistics drift by 1%
    (yp_jf, _), st_jf, _ = jfull(pj, st, qs, x, True)
    with torch.no_grad():
        (yp_f, _), st_f, _ = tfull(pt, stt, qt, torch.from_numpy(
            np.asarray(x)), True)
    for a, b in zip(yp_jf, yp_f):
        _close_to_norm(b.numpy(), np.asarray(a), 1e-5, 'full heads')
    _close_to_norm(st_f['1']['mean'].numpy(), np.asarray(st_jf['1']['mean']),
                   1e-5, 'full BN mean')
    assert not torch.equal(st_f['1']['mean'], stt['1']['mean'])


def test_bn_frozen_apply_drops_stat_conv(toy_cfg, monkeypatch):
    """The frozen apply runs one conv per quantized conv layer; the full
    train step adds a statistics conv for each conv with BN."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.ops import conv as conv_ops
    net = build_ir(toy_cfg)
    pt, st = from_jax(net, *random_jax_weights(net, seed=2))
    cfg = TQ.QuantConfig(steps=100)
    full = TQ.make_quant_apply(net, cfg)
    calls = []
    real = conv_ops.conv2d_nhwc
    monkeypatch.setattr(conv_ops, 'conv2d_nhwc',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(images(1, 1, 64).astype(np.float32) / 256.0)
    counts = []
    for apply in (full, full.make_bn_frozen()):
        calls.clear()
        with torch.no_grad():
            apply(pt, st, TQ.init_quant_state(net, cfg)[0], x, True)
        counts.append(len(calls))
    n_conv = sum(l.kind == 'conv' for l in net.layers)
    n_bn = sum(l.kind == 'conv' and l.bn for l in net.layers)
    assert counts == [n_conv + n_bn, n_conv]


# ------------------------------------------------------------------ the loop

@pytest.fixture(scope='module')
def qat_set(tmp_path_factory):
    """(root, cfg, .data, initial .npz): 16 JPEG files, a float init."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    root = str(tmp_path_factory.mktemp('qatset'))
    lst = write_jpeg_set(root, n=16, nc=2, seed=5)
    cfg = os.path.join(root, 'leaky.cfg')
    with open(cfg, 'w') as f:
        f.write(LEAKY_CFG)
    with open(os.path.join(root, 'names'), 'w') as f:
        f.write('a\nb\n')
    data = os.path.join(root, 'set.data')
    with open(data, 'w') as f:
        f.write(f'classes=2\ntrain={lst}\nvalid={lst}\n'
                f'names={root}/names\n')
    pj, sj = random_jax_weights(build_ir(cfg), seed=3, conv_scale=0.7)
    init = os.path.join(root, 'init.npz')
    save_checkpoint(init, params=pj, state=sj)
    return root, cfg, data, init


def _run(which, workdir, cfg, data, weights, epochs, resume=False):
    """One QAT ``run_training`` of ``which`` ('jax' or 'torch'): google,
    f32, no augmentation, bs 2; returns its results.txt rows."""
    import jax
    os.makedirs(workdir, exist_ok=True)
    kw = dict(cfg=cfg, data=data, weights=weights, epochs=epochs,
              batch_size=BS, img_size=(64, 64, 64), quantized=1,
              qat_dtype='f32', augment=False, seed=1, resume=resume,
              weights_dir=os.path.join(workdir, 'weights'),
              results_file=os.path.join(workdir, 'results.txt'),
              log_fn=lambda *a: None)
    old = (os.getcwd(), jax.config.jax_default_matmul_precision)
    os.chdir(workdir)
    jax.config.update('jax_default_matmul_precision', 'highest')
    try:
        if which == 'jax':
            from yolo_tpu.train.loop import TrainOptions, run_training
            run_training(TrainOptions(device_mesh=False, **kw))
        else:
            from yolo_tpu_torch.train.loop import TrainOptions, run_training
            run_training(TrainOptions(device='cpu', **kw))
    finally:
        os.chdir(old[0])
        jax.config.update('jax_default_matmul_precision', old[1])
    return np.loadtxt(os.path.join(workdir, 'results.txt'), ndmin=2)


@pytest.fixture(scope='module')
def qat_runs(qat_set):
    root, cfg, data, init = qat_set
    return {w: _run(w, os.path.join(root, w), cfg, data, init, 2)
            for w in ('jax', 'torch')}


def _rows_agree(a, b):
    assert a.shape == b.shape and a.shape[1] == 12
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    for ra, rb in zip(a, b):
        _items_close(ra[1:5], rb[1:5], f'train losses, epoch {rb[0]}')
        _items_close(ra[9:12], rb[9:12], f'val losses, epoch {rb[0]}')
    np.testing.assert_allclose(a[:, 5:9], b[:, 5:9], atol=0.02)


def _checkpoints_agree(path_t, path_j, net, p0):
    from yolo_tpu.utils.checkpoint import load_checkpoint as jload
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    ck, jck = jload(path_t), jload(path_j)
    assert set(ck) == set(jck) and 'qstate' in ck
    assert _qstate_equal(qstate_from_jax(ck['qstate']), jck['qstate'],
                         DRIFT_TOL[2]) > 20
    for key in ('params', 'ema'):
        _params_close(from_jax(net, ck[key], {})[0], jck[key], p0, net, key)


def test_run_training_quantized_matches_jax(qat_runs, qat_set):
    """2 epochs of 8 QAT steps (the BN freeze at step 14 switches to the
    stat-conv-free step in both): results.txt rows (train losses rtol
    1e-2, val losses 1e-2, P/R/mAP/F1 0.02) and last.npz (qstate, params
    and EMA params per group within ``TRAJ_TOL`` of their norm)."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    root, cfg, _, init = qat_set
    _rows_agree(qat_runs['torch'], qat_runs['jax'])
    from yolo_tpu_torch.convert import from_jax
    net = build_ir(cfg)
    ck0 = load_checkpoint(init)
    _checkpoints_agree(os.path.join(root, 'torch', 'weights', 'last.npz'),
                       os.path.join(root, 'jax', 'weights', 'last.npz'),
                       net, from_jax(net, ck0['params'], ck0['state'])[0])
    ck = load_checkpoint(os.path.join(root, 'torch', 'weights', 'last.npz'))
    assert int(np.asarray(ck['qstate']['0']['step'])) == 16


def test_resume_quantized_matches_jax(qat_runs, qat_set):
    """``resume`` from each package's own last.npz for a third epoch: the
    quantizer state comes back from the checkpoint (its steps go on from
    16), the first two rows are carried over, the third agrees."""
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    root, cfg, data, _ = qat_set
    out = {}
    for w in ('jax', 'torch'):
        wd = os.path.join(root, w)
        out[w] = _run(w, wd, cfg, data, os.path.join(wd, 'weights',
                                                     'last.npz'), 3,
                      resume=True)
        np.testing.assert_array_equal(out[w][:2], qat_runs[w])
        ck = load_checkpoint(os.path.join(wd, 'weights', 'last.npz'))
        assert int(np.asarray(ck['qstate']['0']['step'])) == 24
    _rows_agree(out['torch'], out['jax'])


def test_train_cli_quantized_runs(qat_set, tmp_path):
    """``python -m yolo_tpu_torch.train --quantized 2 --device cpu`` (TPSQ:
    the warmup, the bf16 step, the bf16-snap eval) in a subprocess."""
    import subprocess
    _, cfg, data, init = qat_set
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, '-m', 'yolo_tpu_torch.train', '--device', 'cpu',
         '--cfg', cfg, '--data', data, '--weights', init, '--epochs', '1',
         '--batch-size', '8', '--img-size', '64', '--quantized', '2'],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rows = np.loadtxt(tmp_path / 'results.txt', ndmin=2)
    assert rows.shape == (1, 12) and np.isfinite(rows).all()
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    ck = load_checkpoint(str(tmp_path / 'weights' / 'last.npz'))
    assert 'w_scale' in ck['params']['0'] and 'qstate' in ck
    w_scale = np.asarray(ck['params']['0']['w_scale'])
    assert w_scale.shape == () and float(w_scale) != 1.0   # the warmup ran
