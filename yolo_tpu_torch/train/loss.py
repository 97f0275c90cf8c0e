"""YOLO detection loss (counterpart of yolo_tpu/train/loss.py).

Fixed-shape, as in the JAX package: every (anchor, target-slot) pair is
scored densely and the selection is a boolean mask, so shapes never depend
on the label count. Targets arrive as a fixed-capacity (T, 6) tensor
[img, cls, x, y, w, h] (xywh normalised) plus a (T,) validity mask
(``pad_targets``).

Two targets can share a (b, a, cell). The objectness target there is the
last write in the anchor-major pair order, as in the reference and on the
JAX package's f32 path: the winner is computed explicitly, a
``scatter_reduce_('amax')`` of the pair index over the flattened cell index
and a gather of its value, because ``index_put_`` with duplicate indices
has no defined order on CUDA. Writes of unselected pairs are dropped (the
JAX ``mode='drop'``): their flat index points at a dump slot past the end.

Nothing here reads a tensor back to the host or copies one from it, so a
caller can queue the loss behind a forward without a stream synchronise.

It serves the evaluator's val losses and the trainer, whose backward
runs through autograd. JAX's ``stop_gradient``s are ``detach``es here:
the giou inside the objectness target and the returned loss items. The
objectness target carries no gradient, as in JAX: its winner is an
integer index (``scatter_reduce_``, then a gather of the detached
values).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou, wh_iou


class LossHyp(NamedTuple):
    """Static loss hyper-parameters (a subset of the hyp dict)."""
    giou: float = 3.54
    cls: float = 37.4
    cls_pw: float = 1.0
    obj: float = 64.3
    obj_pw: float = 1.0
    iou_t: float = 0.20
    fl_gamma: float = 0.0
    smooth_eps: float = 0.0

    @classmethod
    def from_dict(cls, hyp: dict, nc: int | None = None):
        h = cls(giou=hyp['giou'], cls=hyp['cls'], cls_pw=hyp['cls_pw'],
                obj=hyp['obj'], obj_pw=hyp['obj_pw'], iou_t=hyp['iou_t'],
                fl_gamma=hyp.get('fl_gamma', 0.0),
                smooth_eps=hyp.get('smooth_eps', 0.0))
        if nc is not None:
            h = h._replace(cls=h.cls * nc / 80.0)     # hyp['cls'] *= nc / 80
        return h


def smooth_bce(eps: float = 0.0):
    """Positive / negative label-smoothing targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, labels, pos_weight: float = 1.0):
    """Element-wise binary cross-entropy on logits with a positive weight
    (``BCEWithLogitsLoss`` semantics, unreduced)."""
    return -(pos_weight * labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


def focal_scale(logits, labels, gamma: float, alpha: float = 0.25):
    """Focal modulation factor."""
    p = torch.sigmoid(logits)
    p_t = labels * p + (1 - labels) * (1 - p)
    alpha_factor = labels * alpha + (1 - labels) * (1 - alpha)
    return alpha_factor * (1.0 - p_t) ** gamma


class LayerTargets(NamedTuple):
    """Dense per-YOLO-layer assignment, shapes (na, T) / (na, T, 2)."""
    mask: torch.Tensor    # selected (valid & anchor-iou > iou_t)
    b: torch.Tensor       # image index
    a: torch.Tensor       # anchor index
    gj: torch.Tensor      # grid row
    gi: torch.Tensor      # grid col
    txy: torch.Tensor     # xy offset within the cell
    twh: torch.Tensor     # wh in grid units
    tcls: torch.Tensor    # class index
    av: torch.Tensor      # anchor vec (na, T, 2)


def build_targets_layer(targets, valid, anchor_vec, ny: int, nx: int,
                        iou_t: float) -> LayerTargets:
    """Anchor assignment for one YOLO layer: every target against every
    anchor, rejected below ``iou_t`` of width-height IoU.

    targets: (T, 6) [img, cls, x, y, w, h] normalised; valid: (T,) bool;
    anchor_vec: (na, 2) anchors / stride, on the targets' device. Indices
    are int64 (torch's index type)."""
    na = anchor_vec.shape[0]
    T = targets.shape[0]
    # scalar products, not a (2,) tensor built on the host
    gxy = torch.stack([targets[:, 2] * nx, targets[:, 3] * ny], -1)
    gwh = torch.stack([targets[:, 4] * nx, targets[:, 5] * ny], -1)
    iou = wh_iou(anchor_vec, gwh)                                  # (na, T)
    mask = valid[None, :] & (iou > iou_t)

    b = targets[:, 0].long()[None].expand(na, T)
    c = targets[:, 1].long()[None].expand(na, T)
    a = torch.arange(na, device=targets.device)[:, None].expand(na, T)
    fl = torch.floor(gxy)
    gij = fl.long()
    gi = gij[None, :, 0].expand(na, T)
    gj = gij[None, :, 1].expand(na, T)
    txy = (gxy - fl)[None].expand(na, T, 2)
    twh = gwh[None].expand(na, T, 2)
    av = anchor_vec[:, None, :].expand(na, T, 2)
    return LayerTargets(mask=mask, b=b, a=a, gj=gj, gi=gi, txy=txy, twh=twh,
                        tcls=c, av=av)


def compute_loss(p: Sequence[torch.Tensor], targets, valid, anchor_vecs,
                 nc: int, hyp: LossHyp, gr: float = 1.0,
                 layout: str = 'anchor_major', img_weight=None):
    """Total detection loss.

    p: per-layer raw predictions (bs, na, ny, nx, no), or (bs, ny, nx, na,
    no) with ``layout='nhwc'``; heads may be bf16, the loss math runs in
    f32 (f64 for f64 heads) on the gathered rows and the objectness slice.
    targets: (T, 6) padded; valid: (T,) bool; anchor_vecs: per-layer
    (na, 2) anchors / stride, tensors on the heads' device. gr: the giou
    ratio of the objectness target. img_weight: optional (bs,) 0/1 mask
    that drops the batch's pad slots from every loss mean (the evaluator's
    ragged tail).
    Returns (loss, loss_items (4,) = [lbox, lobj, lcls, total], detached)."""
    cp, cn = smooth_bce(hyp.smooth_eps)
    dev = targets.device
    lbox = torch.zeros((), device=dev)
    lobj = torch.zeros((), device=dev)
    lcls = torch.zeros((), device=dev)

    nhwc = layout == 'nhwc'
    for i, pi in enumerate(p):
        if nhwc:
            bs, ny, nx, na, no = pi.shape
        else:
            bs, na, ny, nx, no = pi.shape
        lt = build_targets_layer(targets, valid, anchor_vecs[i], ny, nx,
                                 hyp.iou_t)
        mask = lt.mask.reshape(-1)                                 # (na*T,)
        n_sel = mask.sum()
        b = lt.b.reshape(-1).clamp(0, bs - 1)       # JAX's gather clamps
        a = lt.a.reshape(-1)
        gj = lt.gj.reshape(-1).clamp(0, ny - 1)
        gi = lt.gi.reshape(-1).clamp(0, nx - 1)

        ldt = torch.promote_types(pi.dtype, torch.float32)
        ps = (pi[b, gj, gi, a] if nhwc
              else pi[b, a, gj, gi]).to(ldt)                       # (na*T, no)
        pxy = torch.sigmoid(ps[:, 0:2])
        pwh = torch.exp(ps[:, 2:4]).clamp(max=1e3) * lt.av.reshape(-1, 2)
        pbox = torch.cat([pxy, pwh], 1)
        tbox = torch.cat([lt.txy.reshape(-1, 2), lt.twh.reshape(-1, 2)], 1)
        giou = bbox_iou(pbox, tbox, x1y1x2y2=False, GIoU=True)
        if img_weight is None:
            w_t = mask.to(torch.float32)
            denom = n_sel.clamp(min=1)
        else:
            w_t = mask * img_weight.to(torch.float32)[b]
            denom = w_t.sum().clamp(min=1.0)
        lbox = lbox + ((1.0 - giou) * w_t).sum() / denom

        # objectness targets: the last-written pair wins at a shared cell
        tobj_val = (1.0 - gr) + gr * giou.detach().clamp(min=0)
        shape = (bs, ny, nx, na) if nhwc else (bs, na, ny, nx)
        flat = (((b * ny + gj) * nx + gi) * na + a if nhwc
                else ((b * na + a) * ny + gj) * nx + gi)
        n_cells = bs * na * ny * nx
        flat = torch.where(mask, flat, n_cells)     # the dump slot
        pair_idx = torch.arange(flat.shape[0], device=dev)
        win = torch.full((n_cells + 1,), -1, dtype=torch.long, device=dev)
        win.scatter_reduce_(0, flat, pair_idx, 'amax')
        win = win[:n_cells].reshape(shape)
        tobj = torch.where(win >= 0, tobj_val[win.clamp(min=0)], 0.0)

        obj_logit = pi[..., 4].to(ldt)
        obj_bce = bce_with_logits(obj_logit, tobj, hyp.obj_pw)
        if hyp.fl_gamma > 0:
            obj_bce = obj_bce * focal_scale(obj_logit, tobj, hyp.fl_gamma)
        if img_weight is None:
            lobj = lobj + obj_bce.mean()
        else:
            iw = img_weight.to(torch.float32).reshape(bs, 1, 1, 1)
            lobj = lobj + (obj_bce * iw).sum() / (
                iw.sum().clamp(min=1.0) * (na * ny * nx))

        if nc > 1:
            # one-hot by comparison: a class index out of range sets
            # nothing, as the JAX scatter drops it
            hot = torch.arange(nc, device=dev)[None] == lt.tcls.reshape(-1, 1)
            t_cls = torch.where(hot, cp, cn)
            cls_bce = bce_with_logits(ps[:, 5:], t_cls, hyp.cls_pw)
            if hyp.fl_gamma > 0:
                cls_bce = cls_bce * focal_scale(ps[:, 5:], t_cls, hyp.fl_gamma)
            lcls = lcls + (cls_bce * w_t[:, None]).sum() / (denom * nc)

    lbox = lbox * hyp.giou
    lobj = lobj * hyp.obj
    lcls = lcls * hyp.cls
    loss = lbox + lobj + lcls
    return loss, torch.stack([lbox, lobj, lcls, loss]).detach()


def pad_targets(labels_list, max_t: int):
    """Host-side: per-image (n_i, 5) [cls, x, y, w, h] arrays ->
    ((max_t, 6) padded targets, (max_t,) valid mask), numpy."""
    rows = []
    for img_i, lab in enumerate(labels_list):
        lab = np.asarray(lab, np.float32).reshape(-1, 5)
        if len(lab):
            rows.append(np.concatenate(
                [np.full((len(lab), 1), img_i, np.float32), lab], axis=1))
    if rows:
        cat = np.concatenate(rows, axis=0)
        if len(cat) > max_t:
            # dropped boxes train their cells toward background: surface it
            import warnings
            warnings.warn(
                f'pad_targets: {len(cat) - max_t} of {len(cat)} labels '
                f'truncated (raise --max-targets)', stacklevel=2)
            cat = cat[:max_t]
    else:
        cat = np.zeros((0, 6), np.float32)
    out = np.zeros((max_t, 6), np.float32)
    out[:len(cat)] = cat
    valid = np.zeros(max_t, bool)
    valid[:len(cat)] = True
    return out, valid
