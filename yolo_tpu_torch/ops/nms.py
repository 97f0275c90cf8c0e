"""Batched non-max suppression (counterpart of yolo_tpu/ops/nms.py).

Fixed-shape pipeline over an explicit batch dimension:

  1. score = obj * cls; multi-label candidates by a top-k over (boxes * nc)
  2. wh / conf / finite constraints as zeroed scores (no dynamic shapes)
  3. greedy NMS on class-offset boxes as an iterative fixpoint, plus
     merge-NMS box fusion: ``ops/nms_suppress.suppress`` (a CUDA kernel on
     the card, its plain twin on the CPU)
  4. ``max_det`` output slots per image; empty slots are all zero

Every top-k is a stable descending sort, so equal scores keep the lower
index first on every device. (The JAX package's CPU top-k does so too,
except ``lax.approx_max_k`` with k equal to the input length.) Output per
image: (max_det, 6) = (x1, y1, x2, y2, conf, cls).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .boxes import xywh2xyxy
from .nms_suppress import suppress, suppress_reference

MIN_WH, MAX_WH = 2.0, 4096.0  # box constraints (pixels)


def _topk(x, k: int):
    """Top-k along the last dim; among equal values the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x, idx):
    """x (bs, n, c), idx (bs, m) -> (bs, m, c)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _pairs(box_xywh, obj, cls, conf_thres, top_k, multi_label, agnostic,
           classes=None):
    """Multi-label (box, class) candidate pairs from pre-selected boxes.

    box_xywh (bs, box_k, 4), obj (bs, box_k) (0 where filtered), cls
    (bs, box_k, nc). Excluded ``classes`` are zeroed before the top-k, so
    they never take candidate or output slots. Returns fixed-k,
    score-sorted (boxes, oboxes, cand_scores, cls_idx, valid)."""
    nc = cls.shape[-1]
    scores = cls * obj[..., None]
    # a non-finite class score kills only that (box, class) pair
    scores = torch.where(torch.isfinite(scores), scores, 0.0)
    if classes is not None:
        mask = torch.zeros(nc, dtype=torch.bool, device=scores.device)
        for c in classes:           # scalar fills: no host-to-device copy
            mask[c] = True
        scores = torch.where(mask, scores, 0.0)
    if not (multi_label and nc > 1):
        best = scores.amax(-1, keepdim=True)
        scores = torch.where(scores == best, scores, 0.0)
    scores = torch.where(scores > conf_thres, scores, 0.0)

    bs, box_k = scores.shape[:2]
    k = min(top_k, box_k * nc)
    # a pair can rank in the global top-k only if its box's best pair does:
    # top-k boxes by best pair first, then rank the pairs of those boxes
    if box_k > k:
        _, bsel = _topk(scores.amax(-1), k)
        scores = _gather_rows(scores, bsel)
    else:
        bsel = torch.arange(box_k, device=scores.device).expand(bs, box_k)

    cand_scores, cand_idx = _topk(scores.reshape(bs, -1), k)
    box_idx = torch.gather(bsel, 1, cand_idx // nc)
    cls_idx = (cand_idx % nc).to(torch.float32)
    valid = cand_scores > conf_thres

    boxes = xywh2xyxy(_gather_rows(box_xywh, box_idx))
    offset = torch.zeros_like(cls_idx) if agnostic else cls_idx * MAX_WH
    return boxes, boxes + offset[..., None], cand_scores, cls_idx, valid


def _candidates(pred, conf_thres, top_k, multi_label, agnostic, classes=None):
    """Candidate selection from decoded pred (bs, N, 5 + nc)."""
    box_xywh, obj, cls = pred[..., :4], pred[..., 4], pred[..., 5:]
    wh_ok = ((box_xywh[..., 2:4] > MIN_WH)
             & (box_xywh[..., 2:4] < MAX_WH)).all(-1)
    # box + obj finite per box; class scores are checked per pair in _pairs
    finite_ok = torch.isfinite(pred[..., :5]).all(-1)
    base_ok = wh_ok & finite_ok & (obj > conf_thres)
    # stage 1: pre-select boxes by objectness (score = obj * cls <= obj)
    box_k = min(max(4 * top_k, 256), obj.shape[1])
    obj_top, box_sel = _topk(torch.where(base_ok, obj, 0.0), box_k)
    return _pairs(_gather_rows(box_xywh, box_sel), obj_top,
                  _gather_rows(cls, box_sel), conf_thres, top_k, multi_label,
                  agnostic, classes)


def _finalize(boxes, cand_scores, cls_idx, keep, max_det):
    """Rank the kept candidates into max_det output slots."""
    bs, k = cand_scores.shape
    sel_scores, sel = _topk(torch.where(keep, cand_scores, 0.0),
                            min(max_det, k))
    det = torch.cat([_gather_rows(boxes, sel), sel_scores[..., None],
                     torch.gather(cls_idx, 1, sel)[..., None]], -1)
    det = torch.where((sel_scores > 0)[..., None], det, 0.0)
    if max_det > k:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_det - k))
    return det


def _suppress_and_finalize(boxes, oboxes, cand_scores, cls_idx, valid,
                           iou_thres, merge, max_sweeps, max_det,
                           plain=False):
    # zero the invalid rows first: the merge multiplies every row by its
    # weight, and 0 * inf = NaN would poison every merged box of the image
    boxes = torch.where(valid[..., None], boxes, 0.0)
    oboxes = torch.where(valid[..., None], oboxes, 0.0)
    fn = suppress_reference if plain else suppress
    keep, merged = fn(oboxes.contiguous(), boxes.contiguous(),
                      (cand_scores * valid).contiguous(), valid.contiguous(),
                      iou_thres=iou_thres, max_sweeps=max_sweeps, merge=merge)
    merged = torch.where(keep[..., None], merged, boxes)
    return _finalize(merged, cand_scores, cls_idx, keep, max_det)


def non_max_suppression(pred, conf_thres: float = 0.1, iou_thres: float = 0.6,
                        top_k: int = 512, max_det: int = 300,
                        multi_label: bool = True, agnostic: bool = False,
                        merge: bool = True, max_sweeps: int = 16,
                        classes: tuple | None = None, plain: bool = False):
    """Batched NMS: pred (bs, N, 5 + nc) f32 -> (bs, max_det, 6).

    ``max_sweeps`` bounds the fixpoint: the result is exactly greedy NMS
    whenever suppression chains are shorter than the cap. ``plain`` runs
    the suppression's plain PyTorch version instead of the kernel (for
    holding one against the other on the card)."""
    boxes, oboxes, cand_scores, cls_idx, valid = _candidates(
        pred, conf_thres, top_k, multi_label, agnostic, classes)
    return _suppress_and_finalize(boxes, oboxes, cand_scores, cls_idx, valid,
                                  iou_thres, merge, max_sweeps, max_det, plain)


def _heads_candidates(heads, anchors, strides, no, conf_thres, top_k,
                      objs=None, head_scales=None):
    """Sparse decode: pre-select boxes from the raw NHWC head maps and
    decode only those, never building the (bs, N, 5 + nc) io.

    heads: list of (bs, ny, nx, na*no); anchors: per-scale (na, 2) pixel
    anchors (device tensors avoid a host-to-device copy per call); objs:
    optional per-scale objectness-logit maps (bs, ny, nx, na), entries may
    be None. A scale with an obj map runs in cell mode (top-k cells by
    their best-anchor logit, all na anchors of a cell gathered); one
    without runs in row mode (top-k (cell, anchor) rows by the obj logit).
    head_scales: optional per-scale dequant factors of int8 heads (the int8
    engine); entries may be None for a float head. An int8 head is
    gathered first and only the gathered rows are dequantized.
    Returns batched (box_xywh, obj, cls), ready for ``_pairs``."""
    bs = heads[0].shape[0]
    sizes = [(x.shape[1], x.shape[2], x.shape[3] // no) for x in heads]
    n_total = sum(ny * nx * na for ny, nx, na in sizes)
    box_k = min(max(4 * top_k, 256), n_total)
    # conf_thres in logit space (sigmoid is monotonic); t <= 0: no filter
    logit_thres = (math.log(conf_thres / (1.0 - conf_thres)) if conf_thres > 0
                   else -math.inf)
    objs = [None] * len(heads) if objs is None else objs
    head_scales = ([None] * len(heads) if head_scales is None
                   else head_scales)

    rows_all, obj_all = [], []
    for x, om, hs, (ny, nx, na), anc, stride in zip(
            heads, objs, head_scales, sizes, anchors, strides):
        dev = x.device
        n_s = ny * nx * na
        # per-scale quota: at least top_k plus a proportional share
        k_s = min(n_s, max(top_k, round(box_k * n_s / n_total)))
        if om is not None:
            n_c = ny * nx
            omax = om.reshape(bs, n_c, na).to(torch.float32).amax(-1)
            k_c = min(n_c, -(-k_s // na))
            masked = torch.where(omax > logit_thres, omax, -math.inf)
            _, cidx = _topk(masked, k_c)
            cells = _gather_rows(x.reshape(bs, n_c, na * no), cidx)
            rows = cells.reshape(bs, k_c * na, no).to(torch.float32)
            if hs is not None:
                rows = rows * hs
            cell = cidx.repeat_interleave(na, dim=1)
            a = torch.arange(na, device=dev).repeat(k_c)[None]
        else:
            v = x.reshape(bs, n_s, no)              # row i = (y*nx + x)*na + a
            obj_logit = v[..., 4].to(torch.float32)
            if hs is not None:
                obj_logit = obj_logit * hs
            masked = torch.where(obj_logit > logit_thres, obj_logit, -math.inf)
            _, idx = _topk(masked, k_s)
            rows = _gather_rows(v, idx).to(torch.float32)
            if hs is not None:
                rows = rows * hs
            a = idx % na
            cell = idx // na

        # decode the selected rows (the math of decode_yolo_nhwc)
        grid = torch.stack([cell % nx, cell // nx], -1).to(torch.float32)
        anc = torch.as_tensor(anc, dtype=torch.float32, device=dev)
        xy = (torch.sigmoid(rows[..., 0:2]) + grid) * stride
        wh = torch.exp(rows[..., 2:4]) * anc[a]
        rows_all.append(torch.cat([xy, wh, torch.sigmoid(rows[..., 5:])], -1))
        obj_all.append(torch.sigmoid(rows[..., 4]))

    rows = torch.cat(rows_all, 1)                   # (bs, K, 4 + nc)
    obj = torch.cat(obj_all, 1)                     # (bs, K)
    box_xywh = rows[..., :4]
    wh_ok = ((box_xywh[..., 2:4] > MIN_WH)
             & (box_xywh[..., 2:4] < MAX_WH)).all(-1)
    finite_ok = torch.isfinite(box_xywh).all(-1) & torch.isfinite(obj)
    obj = torch.where(wh_ok & finite_ok & (obj > conf_thres), obj, 0.0)

    # reduce the concatenated per-scale quotas to the global box_k buffer
    if obj.shape[1] > box_k:
        obj, sel = _topk(obj, box_k)
        rows = _gather_rows(rows, sel)
    return rows[..., :4], obj, rows[..., 4:]


def non_max_suppression_heads(heads, anchors, strides, no: int,
                              conf_thres: float = 0.1, iou_thres: float = 0.6,
                              top_k: int = 512, max_det: int = 300,
                              multi_label: bool = True, agnostic: bool = False,
                              merge: bool = True, max_sweeps: int = 16,
                              objs=None, classes: tuple | None = None,
                              head_scales=None, plain: bool = False):
    """Batched NMS straight from the raw NHWC head maps (sparse decode).

    Same contract as :func:`non_max_suppression`. heads: list of
    (bs, ny, nx, na*no); anchors: per-scale (na, 2) pixel anchors; strides:
    per-scale ints; objs: optional objectness-logit maps from
    ``Darknet.forward_heads`` or the int8 engine; head_scales: per-scale
    dequant factors of int8 heads (``make_int8_apply(...).head_scales``).
    Output (bs, max_det, 6)."""
    box_xywh, obj, cls = _heads_candidates(heads, anchors, strides, no,
                                           conf_thres, top_k, objs=objs,
                                           head_scales=head_scales)
    boxes, oboxes, cand_scores, cls_idx, valid = _pairs(
        box_xywh, obj, cls, conf_thres, top_k, multi_label, agnostic, classes)
    return _suppress_and_finalize(boxes, oboxes, cand_scores, cls_idx, valid,
                                  iou_thres, merge, max_sweeps, max_det, plain)


def to_host_detections(dets) -> list:
    """(bs, max_det, 6) -> per-image ndarray (n, 6), or None for no detection."""
    dets = dets.detach().cpu().numpy() if torch.is_tensor(dets) else np.asarray(dets)
    out = []
    for d in dets:
        d = d[d[:, 4] > 0]
        out.append(d if len(d) else None)
    return out
