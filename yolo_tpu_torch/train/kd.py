"""Knowledge-distillation losses, strategies 1-6 (counterpart of
``yolo_tpu/train/kd.py``).

Each strategy is a function of the student's and the teacher's head maps
(and, for KD4/KD5, their ``feature_out`` maps) and of the batch's
fixed-capacity targets; ``make_kd_loss_fn`` binds one to a teacher model
as the trainer's ``kd_loss_fn`` hook. The reductions run in f32 from bf16
heads. Targets are assigned densely, as in ``train/loss.py``: (anchor,
slot) grids with a boolean mask, so no shape depends on the label count
and nothing reads a value back to the host.

Where JAX scatters with ``mode='drop'`` (the invalid rows of KD5's
foreground mask and KD6's output mask), the port writes those rows to a
dump batch row past the end and slices it off. KD5's mask is built once
per distinct map size in a step, every offset of every target in one
``index_put_`` (the writes all set 1.0, so their order does not matter).

In a data-parallel step (``group``, the mesh's data group) each rank holds
its block of the global batch: the teacher's BN takes the global batch's
statistics, the batch-size divisors are the global batch size, and the
counts and sums over the batch are all-reduced, so that each rank's term
is its share of the global batch's and the shares sum to it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce, all_reduce_nograd, world
from .loss import build_targets_layer

T_KD = 3.0  # distillation temperature (all strategies)


def _kl_div_sum(log_p_s, p_t):
    """``KLDivLoss(reduction='sum')(log_p_s, p_t)``:
    sum(p_t * (log p_t - log_p_s))."""
    log_p_t = torch.log(p_t.clamp_min(1e-12))
    return torch.sum(p_t * (log_p_t - log_p_s))


def _soft_kl(student_logits, teacher_logits, T=T_KD):
    """KL(softmax(t/T) || softmax(s/T)) summed, times T^2, in f32."""
    log_ps = F.log_softmax(student_logits.float() / T, dim=-1)
    pt = F.softmax(teacher_logits.float() / T, dim=-1)
    return _kl_div_sum(log_ps, pt) * (T * T)


def kd1(output_s: Sequence, output_t: Sequence, nc: int, batch_size: int):
    """Global KL over all raw outputs."""
    Lambda_ST = 0.001
    s = torch.cat([o.reshape(-1, nc + 5) for o in output_s], 0)
    t = torch.cat([o.reshape(-1, nc + 5) for o in output_t], 0)
    return _soft_kl(s, t) / batch_size * Lambda_ST


def _gathered_boxes(p, lt, layout: str = 'anchor_major'):
    """Decoded boxes at the assigned cells, (na*T, 4) in grid units, from
    a (bs, ny, nx, na, no) head (``layout='nhwc'``) or a (bs, na, ny, nx,
    no) one: the same rows either way. Indices are clamped into range as
    JAX's gather clamps them (a padded target's rows are masked later)."""
    if layout == 'nhwc':
        bs, ny, nx, na, _ = p.shape
    else:
        bs, na, ny, nx, _ = p.shape
    b = lt.b.reshape(-1).clamp(0, bs - 1)
    a = lt.a.reshape(-1)
    gj = lt.gj.reshape(-1).clamp(0, ny - 1)
    gi = lt.gi.reshape(-1).clamp(0, nx - 1)
    ps = (p[b, gj, gi, a] if layout == 'nhwc' else p[b, a, gj, gi]).float()
    xy = torch.sigmoid(ps[:, 0:2])
    wh = torch.exp(ps[:, 2:4]) * lt.av.reshape(-1, 2)
    return torch.cat([xy, wh], 1)


def _per_layer_targets(output_s, targets, valid, anchor_vecs, iou_t=0.2,
                       layout: str = 'anchor_major'):
    """``build_targets_layer`` for each head; ``anchor_vecs`` are (na, 2)
    tensors on the targets' device."""
    lts = []
    for p, av in zip(output_s, anchor_vecs):
        if layout == 'nhwc':
            _, ny, nx, _, _ = p.shape
        else:
            _, _, ny, nx, _ = p.shape
        lts.append(build_targets_layer(targets, valid, av, ny, nx, iou_t))
    return lts


def _box_and_cls_terms(output_s, output_t, lts, nc, layout, group=None):
    """KD3-5's shared terms: the L2 of student to teacher boxes at the
    assigned cells, and the KL of the obj/cls logits over every map
    (divided by the global batch size under ``group``)."""
    lcls = output_s[0].new_zeros((), dtype=torch.float32)
    lbox = lcls
    for ps_raw, pt_raw, lt in zip(output_s, output_t, lts):
        mask = lt.mask.reshape(-1)
        psbox = _gathered_boxes(ps_raw, lt, layout)
        ptbox = _gathered_boxes(pt_raw, lt, layout)
        lbox = lbox + torch.sum(torch.sum(torch.square(psbox - ptbox), 1)
                                * mask)
        s_oc = ps_raw[..., 4:].reshape(-1, nc + 1)
        t_oc = pt_raw[..., 4:].reshape(-1, nc + 1)
        lcls = lcls + _soft_kl(s_oc, t_oc) / (ps_raw.shape[0] * world(group))
    return lcls, lbox


def kd2(output_s, output_t, targets, valid, anchor_vecs, nc: int,
        iou_t: float = 0.2, layout: str = 'anchor_major', group=None):
    """L2 to the ground truth where the student is farther from it than
    the teacher (+ a margin), and the KL of obj/cls. Returns (loss,
    reg_ratio), the ratio of the global batch's counts under ``group``."""
    reg_m = 0.0
    Lambda_cls, Lambda_box = 0.0001, 0.001
    lcls = output_s[0].new_zeros((), dtype=torch.float32)
    lbox = reg_num = reg_nb = lcls
    lts = _per_layer_targets(output_s, targets, valid, anchor_vecs, iou_t,
                             layout)
    for ps_raw, pt_raw, lt in zip(output_s, output_t, lts):
        mask = lt.mask.reshape(-1)
        tbox = torch.cat([lt.txy.reshape(-1, 2), lt.twh.reshape(-1, 2)], 1)
        psbox = _gathered_boxes(ps_raw, lt, layout)
        ptbox = _gathered_boxes(pt_raw, lt, layout)
        d_s = torch.sum(torch.square(psbox - tbox), 1)
        d_t = torch.sum(torch.square(ptbox - tbox), 1)
        worse = (d_s + reg_m > d_t) & mask
        lbox = lbox + torch.sum(d_s * worse)
        reg_num = reg_num + torch.sum(worse)
        reg_nb = reg_nb + torch.sum(mask)
        s_oc = ps_raw[..., 4:].reshape(-1, nc + 1)
        t_oc = pt_raw[..., 4:].reshape(-1, nc + 1)
        lcls = lcls + _soft_kl(s_oc, t_oc) / (ps_raw.shape[0] * world(group))
    if group is not None:
        reg_num, reg_nb = all_reduce_nograd(torch.stack([reg_num, reg_nb]),
                                            group)
    reg_ratio = reg_num / torch.clamp_min(reg_nb, 1)
    return lcls * Lambda_cls + lbox * Lambda_box, reg_ratio


def kd3(output_s, output_t, targets, valid, anchor_vecs, nc: int,
        iou_t: float = 0.2, layout: str = 'anchor_major', group=None):
    """L2 of student to teacher boxes at the assigned cells + KL of
    obj/cls."""
    Lambda_cls, Lambda_box = 0.0001, 0.001
    lts = _per_layer_targets(output_s, targets, valid, anchor_vecs, iou_t,
                             layout)
    lcls, lbox = _box_and_cls_terms(output_s, output_t, lts, nc, layout,
                                    group)
    return lcls * Lambda_cls + lbox * Lambda_box


def _feature_saliency(f):
    """NHWC feature -> per-pixel |.|-sum saliency rows (bs, h*w)."""
    return torch.sum(torch.abs(f), -1).reshape(f.shape[0], -1)


def kd4(output_s, output_t, feature_s, feature_t, targets, valid,
        anchor_vecs, nc: int, batch_size: int, iou_t: float = 0.2,
        layout: str = 'anchor_major', group=None):
    """KD3 + the KL of the feature maps' |sum| saliency. The maps pair by
    ``zip``: a student with fewer maps distils only its first ones.
    ``batch_size`` is the global batch's under ``group``."""
    # KD4 and KD5 weight cls at 0.001, KD2 and KD3 at 0.0001
    Lambda_cls, Lambda_box, Lambda_feature = 0.001, 0.001, 0.001
    lts = _per_layer_targets(output_s, targets, valid, anchor_vecs, iou_t,
                             layout)
    lcls, lbox = _box_and_cls_terms(output_s, output_t, lts, nc, layout,
                                    group)
    lfeat = lcls.new_zeros(())
    for fs, ft_ in zip(feature_s, feature_t):
        lfeat = lfeat + _soft_kl(_feature_saliency(fs),
                                 _feature_saliency(ft_)) / batch_size
    return lcls * Lambda_cls + lbox * Lambda_box + lfeat * Lambda_feature


def _foreground_mask(h, w, lts, strides, img_size, mode: str = 'rect'):
    """``build(bs)`` -> the (bs, h, w) f32 foreground mask of every
    assigned target cell, expanded to the feature resolution.

    mode 'rect': the full e x e cell rectangle each target cell expands
    to. mode 'diag': the reference's footprint, the top-left corner and
    the diagonal (base+k, base+k) of that rectangle (it appends the gj and
    gi ranges independently). All offsets of all heads go into one
    ``index_put_``; invalid rows land in a dump row at batch index bs."""
    scale = img_size / h

    def build(bs):
        bb, jj, ii = [], [], []
        for lt, stride in zip(lts, strides):
            if stride < scale:
                continue
            e = max(int(stride / scale), 1)
            b = lt.b.reshape(-1)
            base_j = (lt.gj.reshape(-1) * stride / scale).to(torch.int64)
            base_i = (lt.gi.reshape(-1) * stride / scale).to(torch.int64)
            b_w = torch.where(lt.mask.reshape(-1), b, bs)
            k = torch.arange(e, device=b.device)
            if mode == 'diag':
                dj = di = k
            else:
                dj = k.repeat_interleave(e)
                di = k.repeat(e)
            n = dj.numel()
            bb.append(b_w[:, None].expand(-1, n).reshape(-1))
            jj.append((base_j[:, None] + dj).clamp(0, h - 1).reshape(-1))
            ii.append((base_i[:, None] + di).clamp(0, w - 1).reshape(-1))
        m = torch.zeros((bs + 1, h, w), device=lts[0].b.device)
        if bb:
            m.index_put_((torch.cat(bb), torch.cat(jj), torch.cat(ii)),
                         torch.ones((), device=m.device))
        return m[:bs]
    return build


def kd5(output_s, output_t, feature_s, feature_t, targets, valid,
        anchor_vecs, nc: int, batch_size: int, img_size: int,
        strides: Sequence[int], iou_t: float = 0.2, mask_mode: str = 'rect',
        layout: str = 'anchor_major', group=None):
    """KD4 with the feature saliency masked to the targets' foreground
    (``_foreground_mask``, ``mask_mode`` 'rect' or 'diag')."""
    Lambda_cls, Lambda_box, Lambda_feature = 0.001, 0.001, 0.001
    lts = _per_layer_targets(output_s, targets, valid, anchor_vecs, iou_t,
                             layout)
    lcls, lbox = _box_and_cls_terms(output_s, output_t, lts, nc, layout,
                                    group)
    lfeat = lcls.new_zeros(())
    masks: dict = {}
    for fs, ft_ in zip(feature_s, feature_t):
        bs, h, w, _ = fs.shape
        if (h, w) not in masks:
            masks[h, w] = _foreground_mask(h, w, lts, strides, img_size,
                                           mask_mode)(bs)
        fg = masks[h, w]
        sal_s = (torch.sum(torch.abs(fs), -1) * fg).reshape(bs, -1)
        sal_t = (torch.sum(torch.abs(ft_), -1) * fg).reshape(bs, -1)
        lfeat = lfeat + _soft_kl(sal_s, sal_t) / batch_size
    return lcls * Lambda_cls + lbox * Lambda_box + lfeat * Lambda_feature


def kd6(output_s, output_t, targets, valid, anchor_vecs, nc: int,
        batch_size: int, iou_t: float = 0.2):
    """Output masking: every raw output zeroed but the assigned (b, a, gj,
    gi) cells, then a global KL over rows of na*(nc+5). Anchor-major heads
    only (its row grouping is tied to that layout)."""
    Lambda_feature = 0.001
    lts = _per_layer_targets(output_s, targets, valid, anchor_vecs, iou_t)
    rows_s, rows_t = [], []
    for ps_raw, pt_raw, lt in zip(output_s, output_t, lts):
        bs, na, ny, nx, no = ps_raw.shape
        mask = ps_raw.new_zeros((bs + 1, na, ny, nx))
        b_w = torch.where(lt.mask.reshape(-1), lt.b.reshape(-1), bs)
        mask.index_put_((b_w, lt.a.reshape(-1),
                         lt.gj.reshape(-1).clamp(0, ny - 1),
                         lt.gi.reshape(-1).clamp(0, nx - 1)),
                        torch.ones((), dtype=mask.dtype, device=mask.device))
        mask = mask[:bs, ..., None]
        rows_s.append((ps_raw * mask).reshape(-1, na * no))
        rows_t.append((pt_raw * mask).reshape(-1, na * no))
    return (_soft_kl(torch.cat(rows_s, 0), torch.cat(rows_t, 0))
            / batch_size * Lambda_feature)


def failure_case_loss_fm(masks, imgs, targets, valid, group=None):
    """FenceMask's auxiliary loss (nothing calls it, as upstream): the
    masked-pixel share inside against outside the GT boxes, plus the KL
    between the masked and the original images.

    masks/imgs: (bs, h, w, c); targets: padded (T, 6) + valid mask.
    ``group``: this rank's share of the global batch's loss (the shares
    inside and outside the boxes summed over the ranks)."""
    if masks is None:
        return torch.zeros(())
    bs, h, w, _ = imgs.shape
    pbi = torch.mean(masks[..., 0], dim=(1, 2)).sum()
    dev = imgs.device
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    b = targets[:, 0].to(torch.int64)
    x1 = (targets[:, 2] - targets[:, 4] / 2) * w
    x2 = (targets[:, 2] + targets[:, 4] / 2) * w
    y1 = (targets[:, 3] - targets[:, 5] / 2) * h
    y2 = (targets[:, 3] + targets[:, 5] / 2) * h
    inside = ((gx >= x1[:, None, None]) & (gx < x2[:, None, None])
              & (gy >= y1[:, None, None]) & (gy < y2[:, None, None]))
    m_per_img = torch.mean(masks, -1)                            # (bs, h, w)
    m_t = m_per_img[b.clamp(0, bs - 1)]                          # (T, h, w)
    area = torch.clamp_min(torch.sum(inside, dim=(1, 2)), 1)
    pbo = torch.sum(torch.sum(m_t * inside, dim=(1, 2)) / area * valid)
    n = world(group)
    if group is not None:
        pbi, pbo = all_reduce(torch.stack([pbi, pbo]), group)
    f_loss = torch.abs(pbi - pbo) / (bs * n) / n
    fm = F.log_softmax((masks * imgs).reshape(bs, -1), dim=-1)
    om = F.softmax(imgs.reshape(bs, -1), dim=-1)
    return f_loss + _kl_div_sum(fm, om)


def make_kd_loss_fn(strategy: int, teacher, nc: int, anchor_vecs,
                    img_size: int = 416, strides: Sequence[int] = (32, 16, 8),
                    kd5_mask: str = 'diag', layout: str = 'anchor_major'):
    """The trainer's ``kd_loss_fn(yolo_p, feats, targets, valid, imgs)``
    for ``strategy`` 1-6.

    ``teacher`` is a ``models.network.Darknet`` (its params frozen, in the
    teacher's compute dtype). Each call runs its train forward
    (``forward_train``: BN on the batch's statistics, as JAX runs the
    teacher with ``train=True``) on ``imgs`` without a gradient; the new
    BN statistics it computes are dropped, so the teacher's buffers stay
    as they were loaded. ``layout`` is the head layout of both the student
    step and the teacher ('nhwc' or 'anchor_major', exposed as
    ``.layout``): strategies 1-5 take the same rows from either, KD6 needs
    'anchor_major'. ``anchor_vecs``: per-head (na, 2) anchors / stride.
    In a data-parallel step the trainer passes ``group`` (the mesh's data
    group): the term is then this rank's share of the global batch's."""
    assert not (strategy == 6 and layout == 'nhwc'), \
        "KD6's row grouping requires head_layout='anchor_major'"
    if strategy not in range(1, 7):
        raise ValueError(f'unknown KD strategy {strategy}')
    anchors: dict = {}

    def kd_loss_fn(yolo_p, feats, targets, valid, imgs, group=None):
        with torch.no_grad():
            (t_yolo, t_feats), _ = teacher.forward_train(
                imgs, head_layout=layout, group=group)
        dev = targets.device
        if dev not in anchors:
            anchors[dev] = [torch.as_tensor(a, dtype=torch.float32,
                                            device=dev) for a in anchor_vecs]
        av = anchors[dev]
        bs = imgs.shape[0] * world(group)       # the global batch's
        if strategy == 1:
            return kd1(yolo_p, t_yolo, nc, bs)
        if strategy == 2:
            return kd2(yolo_p, t_yolo, targets, valid, av, nc,
                       layout=layout, group=group)[0]
        if strategy == 3:
            return kd3(yolo_p, t_yolo, targets, valid, av, nc, layout=layout,
                       group=group)
        if strategy == 4:
            return kd4(yolo_p, t_yolo, feats, t_feats, targets, valid, av,
                       nc, bs, layout=layout, group=group)
        if strategy == 5:
            return kd5(yolo_p, t_yolo, feats, t_feats, targets, valid, av,
                       nc, bs, img_size, strides, mask_mode=kd5_mask,
                       layout=layout, group=group)
        return kd6(yolo_p, t_yolo, targets, valid, av, nc, bs)

    kd_loss_fn.layout = layout
    return kd_loss_fn
