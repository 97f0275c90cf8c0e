"""The port's train step (``yolo_tpu_torch.train``: ``batch_norm_train``,
``Darknet.forward_train``, the loss backward, ``grad_fn``, the optimizers,
``burn_in_scalars`` and the EMA) against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and the port, in
f32 with JAX at 'highest' matmul precision. Tolerances (relative to each
tensor's largest magnitude where it says "of the norm"):

- ``batch_norm_train``: y, running mean and var and the VJP within 1e-5 in
  f32; on bf16 inputs y and the input gradient within one bf16 ulp
  (rtol 2**-7), the f32 statistics within 1e-5;
- the train forward: heads, feature maps and BN state, rtol/atol 1e-4 (as
  the eval forward's tests);
- the loss gradients with respect to the head maps: rtol 1e-5, atol 1e-5
  of the largest gradient;
- ``grad_fn``'s parameter gradients: 1e-4 of each tensor's norm, in f32
  and in the f64 reference mode;
- one optimizer update: 1e-6; ``burn_in_scalars`` exactly; the EMA 1e-7.

The test marked ``gpu`` runs the step on the card against the CPU and
skips without one; this module imports no jax at the top, so it runs on a
machine without jax:
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_train_step.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BF16_ULP = 2.0 ** -7
SE_CFG = 'cfg/yolov3tiny-mobilenet-small/yolov3tiny-mobilenet-small-coco.cfg'


@pytest.fixture(scope='module', autouse=True)
def _setup():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    prec = None
    try:
        import jax
        prec = jax.config.jax_default_matmul_precision
        jax.config.update('jax_default_matmul_precision', 'highest')
    except ImportError:
        jax = None
    yield
    torch.set_num_threads(old)
    if jax is not None:
        jax.config.update('jax_default_matmul_precision', prec)


@pytest.fixture(scope='module')
def toy_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp('cfg') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return str(p)


def _close_to_norm(got, want, tol, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    scale = max(np.abs(want).max() if want.size else 0.0, 1e-12)
    assert err <= tol * scale, f'{what}: {err} > {tol} * {scale}'


def toy_targets(seed, bs, nc=2, n=6, cap=10, dup=True):
    """(targets (cap, 6), valid (cap,)) numpy: ``n`` boxes over ``bs``
    images; with ``dup`` the second box sits in the first one's cell with
    another size (two targets in one cell)."""
    rng = np.random.default_rng(seed)
    t = np.zeros((cap, 6), np.float32)
    t[:n, 0] = rng.integers(0, bs, n)
    t[:n, 1] = rng.integers(0, nc, n)
    t[:n, 2:4] = rng.uniform(0.1, 0.9, (n, 2))
    t[:n, 4:6] = rng.uniform(0.1, 0.6, (n, 2))
    if dup:
        t[1, :4] = t[0, :4]
        t[1, 4:6] = t[0, 4:6] * 0.8
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return t, valid


# ------------------------------------------------------------ batch norm

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_batch_norm_train_matches_jax(dtype):
    import jax
    import jax.numpy as jnp
    from yolo_tpu.ops.conv import batch_norm_train as jbn
    from yolo_tpu_torch.ops.conv import batch_norm_train
    rng = np.random.default_rng(3)
    n, h, w, c = 2, 5, 6, 7
    x = rng.normal(0.3, 1.5, (n, h, w, c)).astype(np.float32)
    # near-constant: the one-pass E[x^2] - mean^2 would lose ~1e-3 of
    # this variance to cancellation, the two-pass form keeps it
    x[..., 0] = 4.0 + 0.05 * rng.normal(size=(n, h, w))
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 0.2, c).astype(np.float32)
    rm = rng.normal(0, 0.3, c).astype(np.float32)
    rv = rng.uniform(0.5, 2, c).astype(np.float32)
    ct = rng.normal(size=(n, h, w, c)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == 'f32'
                else (jnp.bfloat16, torch.bfloat16))

    def jfn(x_, g_, b_):
        return jbn(x_, g_, b_, jnp.asarray(rm), jnp.asarray(rv), 1e-5, 0.1)
    (jy, jm, jv), vjp = jax.vjp(jfn, jnp.asarray(x).astype(jdt),
                                jnp.asarray(gamma), jnp.asarray(beta))
    jgx, jgg, jgb = vjp((jnp.asarray(ct).astype(jdt),
                         jnp.zeros(c), jnp.zeros(c)))

    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    y, m, v = batch_norm_train(xt, gt, bt, torch.from_numpy(rm),
                               torch.from_numpy(rv), 1e-5, 0.1)
    assert y.dtype == tdt and m.dtype == v.dtype == torch.float32
    assert not m.requires_grad and not v.requires_grad
    y.backward(torch.from_numpy(ct).to(tdt).permute(0, 3, 1, 2))
    f = lambda t: t.detach().to(torch.float32).numpy()
    nhwc = lambda t: f(t.permute(0, 2, 3, 1))
    jf = lambda a: np.asarray(a.astype(jnp.float32))
    np.testing.assert_allclose(m.numpy(), jf(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), jf(jv), rtol=1e-5, atol=1e-6)
    if dtype == 'f32':
        np.testing.assert_allclose(nhwc(y), jf(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(nhwc(xt.grad), jf(jgx), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(nhwc(y), jf(jy), rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(jf(jy)).max())
        np.testing.assert_allclose(nhwc(xt.grad), jf(jgx), rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(jf(jgx)).max())
    _close_to_norm(f(gt.grad), jf(jgg), 1e-5 if dtype == 'f32' else 1e-3)
    _close_to_norm(f(bt.grad), jf(jgb), 1e-5 if dtype == 'f32' else 1e-3)


# ------------------------------------------------------------ train forward

@pytest.mark.parametrize('which', ['toy', 'mobilenet-small'])
def test_train_forward_matches_jax(which, toy_cfg):
    import jax
    import jax.numpy as jnp
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.network import make_apply
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.models.network import Darknet
    cfg = toy_cfg if which == 'toy' else os.path.join(ROOT, SE_CFG)
    # mobilenet-small's last maps are 2x2 at 64 px: batch statistics over 8
    # values amplify the convs' summation-order differences to ~1.5e-4 there
    # by its 48th layer; at 96 px they stay under 4e-5
    size = 64 if which == 'toy' else 96
    net = build_ir(cfg)
    pj, sj = random_jax_weights(net, seed=4, conv_scale=0.7)
    x = images(5, 2, size).astype(np.float32) / 256.0
    for layout in ('nhwc', 'anchor_major'):
        (jy, jf), js = jax.jit(make_apply(net, compute_dtype=None,
                                          head_layout=layout),
                               static_argnums=3)(pj, sj, jnp.asarray(x), True)
        pt, st = from_jax(net, pj, sj)
        m = Darknet(net, pt, st, dtype=None, trainable=True)
        (ty, tf), ts = m.forward_train(torch.from_numpy(x), head_layout=layout)
        assert len(ty) == len(jy) and len(tf) == len(jf)
        for a, b in zip(jy, ty):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=1e-4, atol=1e-4)
        for a, b in zip(jf, tf):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=1e-4, atol=1e-4)
        assert set(ts) == set(js)
        for k in js:
            for f in ('mean', 'var'):
                np.testing.assert_allclose(ts[k][f].numpy(),
                                           np.asarray(js[k][f]),
                                           rtol=1e-4, atol=1e-4)
        # the buffers keep the old statistics; the params stay trainable f32
        for k in st:
            assert torch.equal(m.layer[k].mean, st[k]['mean'])
        assert all(p.requires_grad and p.dtype == torch.float32
                   for p in m.parameters())


def test_dropout_is_identity_in_train_mode(toy_cfg):
    """TOY_CFG has a [dropout] layer: two train forwards give the same
    heads (nothing is dropped, as in the JAX package)."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import Darknet, init_params
    net = build_ir(toy_cfg)
    assert any(l.kind == 'dropout' for l in net.layers)
    p, s = init_params(net, torch.Generator().manual_seed(0))
    m = Darknet(net, p, s, dtype=None, trainable=True)
    x = torch.from_numpy(images(6, 2, 64).astype(np.float32) / 256)
    a = m.forward_train(x)[0][0]
    b = m.forward_train(x)[0][0]
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# ------------------------------------------------------------ loss gradients

@pytest.mark.parametrize('layout', ['nhwc', 'anchor_major'])
@pytest.mark.parametrize('case', ['plain', 'gr_focal'])
def test_loss_gradients_match_jax(layout, case, toy_cfg):
    """d loss / d head maps: ``gr < 1``, two targets in one cell and
    ``fl_gamma > 0`` against ``jax.grad`` of JAX's ``compute_loss``."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.loss import compute_loss as jloss
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.train.loss import LossHyp, compute_loss
    yolos = [l for l in build_ir(toy_cfg).layers if l.kind == 'yolo']
    bs = 3
    rng = np.random.default_rng(7)
    shapes = []
    for l in yolos:
        ny = 64 // l.yolo_stride
        shapes.append((bs, ny, ny, l.na, l.no) if layout == 'nhwc'
                      else (bs, l.na, ny, ny, l.no))
    p = [rng.normal(0, 1.5, s).astype(np.float32) for s in shapes]
    tgt, valid = toy_targets(8, bs)
    avecs = [np.asarray(l.anchors, np.float32) / l.yolo_stride for l in yolos]
    gr = 0.6 if case == 'gr_focal' else 1.0
    fl = 1.5 if case == 'gr_focal' else 0.0
    hyp = dict(giou=3.54, cls=37.4, cls_pw=1.0, obj=64.3, obj_pw=1.0,
               iou_t=0.2, fl_gamma=fl)

    def jl(ps):
        return jloss(ps, jnp.asarray(tgt), jnp.asarray(valid),
                     [jnp.asarray(a) for a in avecs], 2,
                     JHyp.from_dict(hyp, nc=2), gr, layout=layout)[0]
    jg = jax.jit(jax.grad(jl))([jnp.asarray(a) for a in p])
    pt = [torch.from_numpy(a).requires_grad_() for a in p]
    loss, items = compute_loss(pt, torch.from_numpy(tgt),
                               torch.from_numpy(valid),
                               [torch.from_numpy(a) for a in avecs], 2,
                               LossHyp.from_dict(hyp, nc=2), gr, layout=layout)
    assert not items.requires_grad
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax.jit(jl)([jnp.asarray(a) for a in p])),
                               rtol=1e-5)
    for a, b in zip(jg, pt):
        a = np.asarray(a)
        np.testing.assert_allclose(b.grad.numpy(), a, rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max())


# ------------------------------------------------------------ grad_fn

def _jax_step_inputs(net, seed):
    x = images(seed, 2, 64).astype(np.float32) / 256.0
    tgt, valid = toy_targets(seed + 1, 2)
    return x, tgt, valid


@pytest.mark.parametrize('sparse', [False, True])
def test_grad_fn_matches_jax(sparse, toy_cfg):
    """Parameter gradients of two accumulated ``grad_fn`` calls and the new
    BN state, against JAX ``make_train_functions(compute_dtype=None)``;
    ``sparse`` adds the BN-gamma L1 term on the prunable layers."""
    _grad_fn_vs_jax(toy_cfg, sparse, None)


def test_grad_fn_f64_reference_matches_jax(toy_cfg):
    """``compute_dtype=torch.float64`` (the reference that the card's f32
    gradients are held to) runs the convs, the BN statistics and the loss
    in f64, and agrees with JAX's f32 ``grad_fn`` as the f32 port does."""
    ts, items = _grad_fn_vs_jax(toy_cfg, False, torch.float64)
    assert items.dtype == torch.float64
    from yolo_tpu_torch.ops.conv import batch_norm_train
    x = torch.randn(2, 3, 4, 4, dtype=torch.float64)
    one = torch.ones(3, dtype=torch.float64)
    y, m, v = batch_norm_train(x, one, 0 * one, 0 * one, one)
    assert y.dtype == m.dtype == v.dtype == torch.float64


def _grad_fn_vs_jax(toy_cfg, sparse, dtype):
    import jax
    import jax.numpy as jnp
    from yolo_tpu.ir import build_ir
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.trainer import init_train_state as jinit
    from yolo_tpu.train.trainer import make_train_functions as jmake
    from yolo_tpu_torch.compress.prune import prunable_sets_normal
    from yolo_tpu_torch.config import DEFAULT_HYP
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir as tbuild
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    net = build_ir(toy_cfg)
    tnet = tbuild(toy_cfg)
    pj, sj = random_jax_weights(net, seed=9, conv_scale=0.7)
    avecs = [np.asarray(l.anchors) / l.yolo_stride
             for l in net.layers if l.kind == 'yolo']
    layers = tuple(prunable_sets_normal(tnet).prune_idx) if sparse else ()
    s = 0.01 if sparse else 0.0
    jgrad, _ = jmake(net, avecs, 2, JHyp.from_dict(DEFAULT_HYP, nc=2),
                     compute_dtype=None, sparsity_s=s,
                     sparse_gamma_layers=layers)
    jst = jinit(jax.tree.map(jnp.asarray, pj), jax.tree.map(jnp.asarray, sj))
    pt, st = from_jax(net, pj, sj)
    ts = init_train_state(tnet, pt, st, compute_dtype=dtype, device='cpu')
    grad_fn, _ = make_train_functions(tnet, avecs, 2,
                                      LossHyp.from_dict(DEFAULT_HYP, nc=2),
                                      sparsity_s=s,
                                      sparse_gamma_layers=layers)
    for seed, gr in ((11, 0.5), (13, 1.0)):
        x, tgt, valid = _jax_step_inputs(net, seed)
        jst, jitems = jgrad(jst, jnp.asarray(x), jnp.asarray(tgt),
                            jnp.asarray(valid), gr, 0.5)
        ts, items = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(tgt),
                            torch.from_numpy(valid), gr, 0.5)
        np.testing.assert_allclose(items.numpy(), np.asarray(jitems),
                                   rtol=1e-4)
    assert ts.accum_count == 2
    grads, _ = from_jax(net, jax.device_get(jst.grad_accum), {})
    for k, d in ts.params.items():
        for f, p in d.items():
            _close_to_norm(p.grad.numpy(), grads[k][f].numpy(), 1e-4,
                           f'{k}.{f}')
    for k, d in ts.bn_state.items():
        for f in ('mean', 'var'):
            np.testing.assert_allclose(d[f].numpy(),
                                       np.asarray(jst.bn_state[k][f]),
                                       rtol=1e-4, atol=1e-5)
    return ts, items


# ------------------------------------------------------------ optimizers

def _random_tree(rng):
    return {'0': {'w': rng.normal(size=(3, 3, 4, 5)).astype(np.float32),
                  'gamma': rng.uniform(0.5, 1.5, 5).astype(np.float32),
                  'beta': rng.normal(size=5).astype(np.float32)},
            '3': {'b': rng.normal(size=6).astype(np.float32),
                  'w': rng.normal(size=(1, 1, 5, 6)).astype(np.float32)},
            '4': {'fc1': rng.normal(size=(2, 6)).astype(np.float32)}}


@pytest.mark.parametrize('name', ['sgd', 'adam', 'adabound'])
def test_optimizer_update_matches_jax(name):
    """One update from a non-zero state, per-group lr and weight decay."""
    import jax.numpy as jnp
    from yolo_tpu.train import optim as J
    from yolo_tpu_torch.train import optim as T
    rng = np.random.default_rng(12)
    p, g = _random_tree(rng), _random_tree(rng)
    m, v = _random_tree(rng), _random_tree(rng)
    v = {k: {f: np.abs(a) for f, a in d.items()} for k, d in v.items()}
    lr, wd, mu = (0.01, 0.02, 0.005, 0.003), (5e-4, 0.0, 0.0, 0.0), 0.9
    j = lambda t: {k: {f: jnp.asarray(a) for f, a in d.items()}
                   for k, d in t.items()}
    lbl = J.label_tree(p)
    sc = J.PerGroupScalars(lr=jnp.asarray(lr, jnp.float32),
                           weight_decay=jnp.asarray(wd, jnp.float32),
                           momentum=jnp.asarray(mu, jnp.float32))
    if name == 'sgd':
        jp, jo = J.sgd_update(j(p), j(g), J.SGDState(j(m)), lbl, sc)
        tree = {'momentum_buf': m}
    else:
        state = J.AdamState(step=jnp.asarray(3, jnp.int32), m=j(m), v=j(v))
        jp, jo = (J.adam_update(j(p), j(g), state, lbl, sc) if name == 'adam'
                  else J.adabound_update(j(p), j(g), state, lbl, sc,
                                         base_lr=0.01))
        tree = {'step': 3, 'm': m, 'v': v}
    params = {k: {f: torch.nn.Parameter(torch.from_numpy(a.copy()))
                  for f, a in d.items()} for k, d in p.items()}
    for k, d in params.items():
        for f, t in d.items():
            t.grad = torch.from_numpy(g[k][f])
    opt = T.make_optimizer(name, params, base_lr=0.01)
    assert [len(gr['params']) for gr in opt.param_groups] == [2, 2, 2, 0]
    opt.load_state_tree(tree)
    opt.set_scalars(T.PerGroupScalars(lr=lr, weight_decay=wd, momentum=mu))
    opt.step()
    for k, d in params.items():
        for f, t in d.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jp[k][f]), rtol=1e-6,
                                       atol=1e-6)
    got = opt.state_tree()
    if name == 'sgd':
        pairs = [(got['momentum_buf'], jo.momentum_buf)]
    else:
        assert int(got['step']) == int(jo.step) == 4
        pairs = [(got['m'], jo.m), (got['v'], jo.v)]
    for a, b in pairs:
        for k in b:
            for f in b[k]:
                np.testing.assert_allclose(a[k][f].numpy(),
                                           np.asarray(b[k][f]), rtol=1e-6,
                                           atol=1e-6)


def test_group_labels_match_jax(toy_cfg):
    from yolo_tpu.train.optim import label_tree as jlabel
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import init_params
    from yolo_tpu_torch.train.optim import label_tree
    net = build_ir(toy_cfg)
    p, _ = init_params(net)
    assert label_tree(p) == jlabel(p)


def test_burn_in_scalars_match_jax():
    from yolo_tpu.train.schedules import burn_in_scalars as jb
    from yolo_tpu_torch.train.schedules import burn_in_scalars
    for ni, n_burn, epoch, adam, q in ((0, 6, 0, False, False),
                                       (3, 6, 0, False, False),
                                       (6, 6, 1, False, False),
                                       (9, 6, 2, True, False),
                                       (2, 500, 0, True, False),
                                       (4, 6, 3, False, True)):
        kw = dict(lr0=0.001, momentum=0.937, weight_decay=0.000484,
                  epochs=5, batch_size=16, quantized=q, adam=adam)
        js, jgr, jacc = jb(ni, n_burn, epoch, **kw)
        ts, tgr, tacc = burn_in_scalars(ni, n_burn, epoch, **kw)
        assert (tgr, tacc) == (jgr, jacc)
        assert list(ts.lr) == np.asarray(js.lr).tolist()
        assert list(ts.weight_decay) == np.asarray(js.weight_decay).tolist()
        assert ts.momentum == float(np.asarray(js.momentum))


def test_ema_matches_jax():
    """Five EMA updates of params and BN state against JAX's."""
    import jax.numpy as jnp
    from yolo_tpu.train.ema import ema_init as jinit
    from yolo_tpu.train.ema import ema_update as jupd
    from yolo_tpu_torch.train.ema import ema_init, ema_update
    rng = np.random.default_rng(14)
    p0, s0 = _random_tree(rng), {'0': {'mean': rng.normal(size=5)
                                       .astype(np.float32)}}
    j = lambda t: {k: {f: jnp.asarray(a) for f, a in d.items()}
                   for k, d in t.items()}
    t = lambda t_: {k: {f: torch.from_numpy(a.copy()) for f, a in d.items()}
                    for k, d in t_.items()}
    je, te = jinit(j(p0), j(s0)), ema_init(t(p0), t(s0))
    for i in range(5):
        p, s = _random_tree(rng), {'0': {'mean': rng.normal(size=5)
                                         .astype(np.float32)}}
        je, te = jupd(je, j(p), j(s)), ema_update(te, t(p), t(s))
    assert int(te.updates) == int(je.updates) == 5
    for a, b in ((te.params, je.params), (te.state, je.state)):
        for k in b:
            for f in b[k]:
                np.testing.assert_allclose(a[k][f].numpy(),
                                           np.asarray(b[k][f]), rtol=0,
                                           atol=1e-7)


def test_trainer_raises_on_unported_paths(toy_cfg):
    """The remat policies, which once raised, build ('none', 'blocks',
    'full' and JAX's True; ``test_torch_remat.py`` holds them to JAX), and
    an unknown one raises ValueError; QAT under a mesh with a model axis,
    which raised NotImplementedError until the port's last slice, builds,
    its BN-frozen apply and remat too (``tests/test_torch_tp_quant.py``
    holds it to JAX's model mesh); the KD term, which the first training
    slice refused, builds (tests/test_torch_kd.py holds it to JAX)."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.parallel import Mesh
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.trainer import make_train_functions
    net = build_ir(toy_cfg)
    for remat in ('none', 'blocks', 'full', True, False, None):
        make_train_functions(net, [], 2, LossHyp(), remat=remat)
    with pytest.raises(ValueError, match='remat'):
        make_train_functions(net, [], 2, LossHyp(), remat='layers')
    tp = Mesh(shape={'data': 1, 'model': 2}, data_index=0, data_group=None,
              device=torch.device('cpu'), model_group=object())
    qa = TQ.make_quant_apply(net, TQ.QuantConfig(scheme='google'))
    for apply, remat in ((qa, None), (qa.make_bn_frozen(), None),
                         (qa, 'blocks')):
        fns = make_train_functions(net, [], 2, LossHyp(), quant_apply=apply,
                                   mesh=tp, remat=remat)
        assert len(fns) == 2 and all(map(callable, fns))
    make_train_functions(net, [], 2, LossHyp(), kd_loss_fn=lambda *a: 0)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
def test_step_on_card_matches_cpu(toy_cfg):
    """One f32 ``grad_fn`` + ``update_fn`` on the card (TF32 off) against
    the CPU: gradients, params and BN state within 1e-4 of the norm."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from yolo_tpu_torch.config import DEFAULT_HYP
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import init_params
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.schedules import burn_in_scalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = build_ir(toy_cfg)
        p, s = init_params(net, torch.Generator().manual_seed(1),
                           conv_scale=0.7)
        avecs = [np.asarray(l.anchors) / l.yolo_stride
                 for l in net.layers if l.kind == 'yolo']
        grad_fn, update_fn = make_train_functions(
            net, avecs, 2, LossHyp.from_dict(DEFAULT_HYP, nc=2))
        x = images(2, 2, 64).astype(np.float32) / 256
        tgt, valid = toy_targets(3, 2)
        sc = burn_in_scalars(5, 6, 0, lr0=0.01, momentum=0.937,
                             weight_decay=5e-4, epochs=3, batch_size=2)[0]
        out = {}
        for dev in ('cpu', 'cuda'):
            ts = init_train_state(net, p, s, compute_dtype=None, device=dev)
            ts, _ = grad_fn(ts, torch.from_numpy(x).to(dev),
                            torch.from_numpy(tgt).to(dev),
                            torch.from_numpy(valid).to(dev), 0.5, 1.0)
            grads = {f'{k}.{f}': t.grad.cpu().clone()
                     for k, d in ts.params.items() for f, t in d.items()}
            ts = update_fn(ts, sc)
            out[dev] = (grads, {f'{k}.{f}': t.detach().cpu()
                                for k, d in ts.params.items()
                                for f, t in d.items()},
                        {f'{k}.{f}': t.cpu() for k, d in ts.bn_state.items()
                         for f, t in d.items()})
        for a, b in zip(out['cuda'], out['cpu']):
            for k in b:
                _close_to_norm(a[k].numpy(), b[k].numpy(), 1e-4, k)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old
