"""The port's box ops and training-loss forward (``yolo_tpu_torch.ops.boxes``
``bbox_iou`` / ``wh_iou``, ``yolo_tpu_torch.train.loss``) against the JAX
package, on the CPU, f32.

The same numpy-seeded inputs go through ``yolo_tpu.train.loss`` (its f32
path, whose objectness winner at a shared cell is the last-written pair)
and the port. Box ops agree within rtol 1e-6; the loss items within rtol
1e-5 / atol 1e-6 (sums over other reduction orders, and log-sigmoid
formulas that differ by ulps).
"""

import os
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


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
def toy_yolos(tmp_path_factory):
    from yolo_tpu_torch.ir import build_ir
    p = tmp_path_factory.mktemp('cfg') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return [l for l in build_ir(str(p)).layers if l.kind == 'yolo']


def _boxes(rng, n, xyxy):
    cxy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(1, 40, (n, 2))
    if xyxy:
        return np.concatenate([cxy - wh / 2, cxy + wh / 2], 1).astype(np.float32)
    return np.concatenate([cxy, wh], 1).astype(np.float32)


@pytest.mark.parametrize('xyxy', [True, False])
@pytest.mark.parametrize('kind', ['IoU', 'GIoU', 'DIoU', 'CIoU'])
def test_bbox_iou_matches_jax(xyxy, kind):
    """Broadcast (N, 1, 4) x (1, M, 4), overlapping and disjoint pairs."""
    import jax.numpy as jnp
    from yolo_tpu.ops.boxes import bbox_iou as jiou
    from yolo_tpu_torch.ops.boxes import bbox_iou
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 24, xyxy)[:, None], _boxes(rng, 20, xyxy)[None]
    flags = {k: kind == k for k in ('GIoU', 'DIoU', 'CIoU')}
    want = np.asarray(jiou(jnp.asarray(a), jnp.asarray(b), x1y1x2y2=xyxy,
                           **flags))
    got = bbox_iou(torch.from_numpy(a), torch.from_numpy(b), x1y1x2y2=xyxy,
                   **flags).numpy()
    assert got.shape == (24, 20) and (want > 0).any() and (want <= 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_wh_iou_and_iou_matrix_np_match_jax():
    import jax.numpy as jnp
    from yolo_tpu.ops.boxes import box_iou_matrix_np as jnp_iou
    from yolo_tpu.ops.boxes import wh_iou as jwh
    from yolo_tpu_torch.ops.boxes import box_iou_matrix_np, wh_iou
    rng = np.random.default_rng(2)
    a = rng.uniform(0.1, 12, (9, 2)).astype(np.float32)
    b = rng.uniform(0.1, 12, (30, 2)).astype(np.float32)
    np.testing.assert_allclose(
        wh_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jwh(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    p, t = _boxes(rng, 11, True).astype(np.float64), _boxes(rng, 7, True)
    np.testing.assert_array_equal(box_iou_matrix_np(p, t), jnp_iou(p, t))


def test_loss_hyp_smoothing_and_pad_targets_match_jax():
    from yolo_tpu.train import loss as JL
    from yolo_tpu_torch.train import loss as TL
    hyp = dict(giou=3.0, cls=20.0, cls_pw=1.5, obj=50.0, obj_pw=2.0,
               iou_t=0.3, fl_gamma=1.5)
    for nc in (None, 20):
        assert tuple(TL.LossHyp.from_dict(hyp, nc)) == tuple(
            JL.LossHyp.from_dict(hyp, nc))
    assert TL.LossHyp() == tuple(JL.LossHyp())
    assert TL.smooth_bce(0.1) == JL.smooth_bce(0.1)
    rng = np.random.default_rng(3)
    labels = [rng.uniform(0, 1, (n, 5)).astype(np.float32) for n in (3, 0, 5)]
    for max_t in (16, 6):
        with pytest.warns(UserWarning) if max_t == 6 else nullcontext():
            got = TL.pad_targets(labels, max_t)
        with pytest.warns(UserWarning) if max_t == 6 else nullcontext():
            want = JL.pad_targets(labels, max_t)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _loss_inputs(yolos, nc, seed, bs=3, T=24, n_valid=15):
    """Raw heads (bs, na, ny, nx, no) per TOY_CFG yolo layer at 64 px,
    padded targets with two targets in one cell of image 0 (the objectness
    winner), and per-layer anchor vecs; numpy f32."""
    rng = np.random.default_rng(seed)
    no = 5 + nc
    heads = []
    for l in yolos:
        g = 64 // l.yolo_stride
        heads.append(rng.normal(0, 1.5, (bs, l.na, g, g, no)).astype(np.float32))
    tgt = np.zeros((T, 6), np.float32)
    tgt[:n_valid, 0] = rng.integers(0, bs, n_valid)
    tgt[:n_valid, 1] = rng.integers(0, nc, n_valid)
    tgt[:n_valid, 2:4] = rng.uniform(0.05, 0.95, (n_valid, 2))
    tgt[:n_valid, 4:6] = rng.uniform(0.05, 0.6, (n_valid, 2))
    # targets 0 and 1: the same image and centre cell, other sizes
    tgt[1, 0], tgt[1, 2:4] = tgt[0, 0], tgt[0, 2:4] + 0.001
    tgt[1, 4:6] = tgt[0, 4:6] * 1.1
    valid = np.zeros(T, bool)
    valid[:n_valid] = True
    avecs = [(np.asarray(l.anchors, np.float32) / l.yolo_stride)
             for l in yolos]
    return heads, tgt, valid, avecs


LOSS_CASES = [
    # (layout, img_weight, fl_gamma, smooth_eps, nc)
    ('anchor_major', None, 0.0, 0.0, 2),
    ('anchor_major', (1, 1, 0), 0.0, 0.0, 2),
    ('nhwc', None, 0.0, 0.0, 2),
    ('nhwc', (1, 0, 1), 1.5, 0.0, 2),
    ('anchor_major', None, 1.5, 0.1, 2),
    ('anchor_major', (0, 1, 1), 0.0, 0.1, 1),
    ('nhwc', None, 0.0, 0.0, 1),
]


@pytest.mark.parametrize('layout,img_w,gamma,eps,nc', LOSS_CASES)
def test_compute_loss_matches_jax(toy_yolos, layout, img_w, gamma, eps, nc):
    import jax.numpy as jnp
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.loss import compute_loss as jloss
    from yolo_tpu_torch.train.loss import LossHyp, compute_loss
    heads, tgt, valid, avecs = _loss_inputs(toy_yolos, nc, seed=len(layout) + nc)
    if layout == 'nhwc':
        heads = [h.transpose(0, 2, 3, 1, 4).copy() for h in heads]
    kw = dict(fl_gamma=gamma, smooth_eps=eps)
    w = None if img_w is None else np.asarray(img_w, np.float32)
    loss_j, items_j = jloss([jnp.asarray(h) for h in heads], jnp.asarray(tgt),
                            jnp.asarray(valid), avecs, nc, JHyp(**kw), 0.8,
                            layout=layout,
                            img_weight=None if w is None else jnp.asarray(w))
    loss_t, items_t = compute_loss(
        [torch.from_numpy(h) for h in heads], torch.from_numpy(tgt),
        torch.from_numpy(valid), [torch.from_numpy(a) for a in avecs], nc,
        LossHyp(**kw), 0.8, layout=layout,
        img_weight=None if w is None else torch.from_numpy(w))
    assert items_t.shape == (4,) and not items_t.requires_grad
    if nc > 1:
        assert (np.asarray(items_j)[:3] > 0).all()
    np.testing.assert_allclose(items_t.numpy(), np.asarray(items_j), **LOSS_TOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **LOSS_TOL)


def test_build_targets_layer_matches_jax_and_shares_a_cell(toy_yolos):
    """Every field equal to JAX's; targets 0 and 1 are selected into the
    same (b, a, cell) at least once, so the winner is exercised above."""
    import jax.numpy as jnp
    from yolo_tpu.train.loss import build_targets_layer as jbuild
    from yolo_tpu_torch.train.loss import build_targets_layer
    heads, tgt, valid, avecs = _loss_inputs(toy_yolos, 2, seed=4)
    shared = 0
    for h, av in zip(heads, avecs):
        ny, nx = h.shape[2:4]
        want = jbuild(jnp.asarray(tgt), jnp.asarray(valid), jnp.asarray(av),
                      ny, nx, 0.2)
        got = build_targets_layer(torch.from_numpy(tgt),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(av), ny, nx, 0.2)
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        m = got.mask.numpy()
        shared += int((m[:, 0] & m[:, 1]).sum())
    assert shared > 0


@pytest.mark.parametrize('layout', ['anchor_major', 'nhwc'])
def test_tobj_winner_is_the_last_pair(layout):
    """Two targets of one image in one cell, selected by the same anchors,
    on a 2x2 grid where that cell weighs in the objectness mean: the
    objectness target there is the later pair's giou, as in JAX. Swapping
    the two targets changes lobj, so the winner is what is tested."""
    import jax.numpy as jnp
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.loss import compute_loss as jloss
    from yolo_tpu_torch.train.loss import LossHyp, compute_loss
    rng = np.random.default_rng(5)
    head = rng.normal(0, 1.0, (1, 3, 2, 2, 7)).astype(np.float32)
    if layout == 'nhwc':
        head = head.transpose(0, 2, 3, 1, 4).copy()
    av = np.array([[1.0, 1.0], [1.2, 1.2], [5.0, 5.0]], np.float32)
    pair = np.array([[0, 0, 0.30, 0.30, 0.40, 0.40],
                     [0, 1, 0.31, 0.32, 0.20, 0.45]], np.float32)
    valid = np.ones(2, bool)
    lobj = []
    for tgt in (pair, pair[::-1].copy()):
        _, want = jloss([jnp.asarray(head)], jnp.asarray(tgt),
                        jnp.asarray(valid), [av], 2, JHyp(), 1.0,
                        layout=layout)
        _, got = compute_loss([torch.from_numpy(head)], torch.from_numpy(tgt),
                              torch.from_numpy(valid), [torch.from_numpy(av)],
                              2, LossHyp(), 1.0, layout=layout)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
        lobj.append(float(got[1]))
    assert abs(lobj[0] - lobj[1]) > 1e-3 * lobj[0], lobj
