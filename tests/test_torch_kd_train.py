"""The port's knowledge distillation in the train step and the loop (the
KD term of ``grad_fn``, ``run_training(t_cfg=...)``) against the JAX
package, on the CPU (the strategies alone: ``test_torch_kd.py``).

- one f32 ``grad_fn`` step with each strategy's term on ``TOY_CFG``
  (teacher from another seed), JAX at 'highest' matmul precision: loss
  items rtol 1e-4, gradients within 1e-4 of each tensor's norm (the train
  step's tolerance), the teacher's BN statistics unchanged;
- the KD loop (``run_training`` with a teacher, float and QAT) on 8 JPEG
  files: finite results, the checkpoint written.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NC = 2


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


@pytest.fixture(scope='module')
def toy_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp('cfg') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return str(p)


# ------------------------------------------------------------ in the trainer

@pytest.mark.parametrize('strategy,layout,mask', [
    (1, 'nhwc', 'diag'), (2, 'nhwc', 'diag'), (3, 'nhwc', 'diag'),
    (4, 'nhwc', 'diag'), (5, 'nhwc', 'diag'),
    (6, 'anchor_major', 'diag')])
def test_grad_fn_with_kd_matches_jax(strategy, layout, mask, toy_cfg):
    """One f32 ``grad_fn`` step of ``TOY_CFG`` with strategy ``strategy``'s
    term (a teacher of the same cfg from another seed) against JAX's
    ``make_train_functions(kd_loss_fn=...)``: loss items rtol 1e-4,
    gradients and new BN state within 1e-4; the teacher's buffers keep
    their loaded statistics."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.config import DEFAULT_HYP
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.network import make_apply
    from yolo_tpu.train import kd as JK
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.trainer import init_train_state as jinit
    from yolo_tpu.train.trainer import make_train_functions as jmake
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir as tbuild
    from yolo_tpu_torch.models.network import Darknet
    from yolo_tpu_torch.train import kd as TK
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    from test_torch_train_step import _close_to_norm, toy_targets
    net, tnet = build_ir(toy_cfg), tbuild(toy_cfg)
    pj, sj = random_jax_weights(net, seed=9, conv_scale=0.7)
    tpj, tsj = random_jax_weights(net, seed=21, conv_scale=0.7)
    avecs = [np.asarray(l.anchors) / l.yolo_stride
             for l in net.layers if l.kind == 'yolo']
    strides = [l.yolo_stride for l in net.layers if l.kind == 'yolo']
    t_apply = make_apply(net, compute_dtype=None, head_layout=layout)
    jkd = JK.make_kd_loss_fn(strategy, t_apply, jax.tree.map(jnp.asarray, tpj),
                             jax.tree.map(jnp.asarray, tsj), NC, avecs,
                             img_size=64, strides=strides, kd5_mask=mask,
                             layout=layout)
    jgrad, _ = jmake(net, avecs, NC, JHyp.from_dict(DEFAULT_HYP, nc=NC),
                     compute_dtype=None, kd_loss_fn=jkd)
    jst = jinit(jax.tree.map(jnp.asarray, pj), jax.tree.map(jnp.asarray, sj))

    tp, tsd = from_jax(net, tpj, tsj)
    teacher = Darknet(tnet, tp, tsd, dtype=None)
    before = {k: b.clone() for k, b in teacher.state_dict().items()}
    tkd = TK.make_kd_loss_fn(strategy, teacher, NC, avecs, img_size=64,
                             strides=strides, kd5_mask=mask, layout=layout)
    pt, st = from_jax(net, pj, sj)
    ts = init_train_state(tnet, pt, st, compute_dtype=None, device='cpu')
    grad_fn, _ = make_train_functions(tnet, avecs, NC,
                                      LossHyp.from_dict(DEFAULT_HYP, nc=NC),
                                      kd_loss_fn=tkd)
    x = images(11, 2, 64).astype(np.float32) / 256.0
    tgt, valid = toy_targets(12, 2)
    jst, jitems = jgrad(jst, jnp.asarray(x), jnp.asarray(tgt),
                        jnp.asarray(valid), 0.5, 0.5)
    ts, items = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(tgt),
                        torch.from_numpy(valid), 0.5, 0.5)
    np.testing.assert_allclose(items.numpy(), np.asarray(jitems), rtol=1e-4)
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
    for k, b in teacher.state_dict().items():
        assert torch.equal(b, before[k]), k
    assert not any(p.requires_grad for p in teacher.parameters())


def test_kd_term_moves_the_gradient(toy_cfg):
    """The KD term reaches the student: with it the gradients differ from
    the plain step's, and a teacher equal to the student gives KD1 = 0
    (the KL of a distribution with itself)."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import Darknet, init_params
    from yolo_tpu_torch.train import kd as TK
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    from test_torch_train_step import toy_targets
    net = build_ir(toy_cfg)
    p, s = init_params(net, torch.Generator().manual_seed(3), conv_scale=0.7)
    avecs = [np.asarray(l.anchors) / l.yolo_stride
             for l in net.layers if l.kind == 'yolo']
    x = torch.from_numpy(images(4, 2, 64).astype(np.float32) / 256.0)
    tgt, valid = (torch.from_numpy(a) for a in toy_targets(5, 2))
    same = Darknet(net, p, s, dtype=None)
    kd1 = TK.make_kd_loss_fn(1, same, NC, avecs, layout='nhwc')
    ts = init_train_state(net, p, s, compute_dtype=None, device='cpu')
    (yp, feats), _ = ts.model.forward_train(x, head_layout='nhwc')
    assert abs(float(kd1(yp, feats, tgt, valid, x).detach())) < 1e-6
    grads = []
    for kd in (None, TK.make_kd_loss_fn(
            3, Darknet(net, *init_params(net, torch.Generator().manual_seed(4),
                                         conv_scale=0.7), dtype=None),
            NC, avecs, layout='nhwc')):
        ts = init_train_state(net, p, s, compute_dtype=None, device='cpu')
        grad_fn, _ = make_train_functions(net, avecs, NC, LossHyp(),
                                          kd_loss_fn=kd)
        ts, _ = grad_fn(ts, x, tgt, valid, 1.0, 1.0)
        grads.append(ts.params['0']['w'].grad.clone())
    assert not torch.allclose(grads[0], grads[1])


# ------------------------------------------------------------ the loop

@pytest.mark.parametrize('quantized', [-1, 1])
def test_run_training_with_teacher(quantized, tmp_path):
    """``run_training(t_cfg=...)`` on 8 JPEG files, 1 epoch at 64 px (KD5,
    and for QAT KD2 through the google sim): finite results.txt rows, a
    checkpoint written; the CLI path is the same ``TrainOptions``."""
    from yolo_tpu_torch.train.loop import TrainOptions, run_training
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    from test_torch_augment import write_jpeg_set
    root = str(tmp_path)
    lst = write_jpeg_set(root, n=8, nc=2, seed=4)
    cfg = os.path.join(root, 'toy.cfg')
    with open(cfg, 'w') as f:
        f.write(TOY_CFG)
    with open(os.path.join(root, 'names'), 'w') as f:
        f.write('a\nb\n')
    data = os.path.join(root, 'set.data')
    with open(data, 'w') as f:
        f.write(f'classes=2\ntrain={lst}\nvalid={lst}\nnames={root}/names\n')
    net = build_ir(cfg)
    for name, seed in (('s.npz', 3), ('t.npz', 8)):
        pj, sj = random_jax_weights(net, seed=seed, conv_scale=0.7)
        save_checkpoint(os.path.join(root, name), params=pj, state=sj)
    work = tmp_path / 'run'
    work.mkdir()
    old = os.getcwd()
    os.chdir(work)
    try:
        res = run_training(TrainOptions(
            cfg=cfg, data=data, weights=os.path.join(root, 's.npz'),
            t_cfg=cfg, t_weights=os.path.join(root, 't.npz'),
            kd_strategy=5 if quantized == -1 else 2, epochs=1, batch_size=4,
            img_size=(64, 64, 64), quantized=quantized, device='cpu',
            n_burn_override=2, accumulate_override=1, seed=1,
            weights_dir=str(work / 'weights'),
            results_file=str(work / 'results.txt'), log_fn=lambda *a: None))
    finally:
        os.chdir(old)
    rows = np.loadtxt(work / 'results.txt', ndmin=2)
    assert rows.shape == (1, 12) and np.isfinite(rows).all()
    assert len(res) == 7
    assert (work / 'weights' / 'last.npz').exists()
