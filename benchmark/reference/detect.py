"""Decode and suppression in plain PyTorch: head maps -> every box's xyxy,
objectness and class scores -> the candidate boxes -> greedy class-wise
NMS with merged boxes.

The semantics of the reference repository's ``non_max_suppression``
(multi-label, merge), written out exactly: every (box, class) pair whose
score obj * cls passes ``conf``, boxes 2 to 4096 pixels on a side, the
``top_k`` best pairs, greedy suppression above ``iou`` within a class, each
kept box replaced by the score-weighted mean of the pairs of its class
that overlap it above ``iou`` (itself included), and the ``max_det`` best
kept.
"""

from __future__ import annotations

import torch

MIN_WH, MAX_WH = 2.0, 4096.0
EPS = 1e-9


def decode(heads, layers, img_size):
    """(boxes (bs, N, 4) xyxy pixels, obj (bs, N), scores (bs, N, nc) obj *
    cls, sizes) over every anchor of every head, f32, rows in (y, x,
    anchor) order head by head; ``sizes`` (ny, nx, na) a head. A box
    outside the size limits, or not finite, has obj and scores 0."""
    yolos = [l for l in layers if l.kind == 'yolo']
    boxes, objs, scores, sizes = [], [], [], []
    for h, lyr in zip(heads, yolos):
        bs, _, ny, nx = h.shape
        na, no = len(lyr.anchors), lyr.nc + 5
        p = h.float().reshape(bs, na, no, ny, nx).permute(0, 3, 4, 1, 2)
        stride = img_size / ny
        gy, gx = torch.meshgrid(torch.arange(ny, device=h.device),
                                torch.arange(nx, device=h.device),
                                indexing='ij')
        grid = torch.stack([gx, gy], -1).float()[:, :, None]
        anc = torch.tensor(lyr.anchors, dtype=torch.float32, device=h.device)
        xy = (torch.sigmoid(p[..., :2]) + grid) * stride
        wh = torch.exp(p[..., 2:4]) * anc
        box = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        ok = (((wh > MIN_WH) & (wh < MAX_WH)).all(-1, keepdim=True)
              & torch.isfinite(box).all(-1, keepdim=True))
        obj = torch.sigmoid(p[..., 4:5])
        obj = torch.where(ok & torch.isfinite(obj), obj, 0.0)
        sc = obj * torch.sigmoid(p[..., 5:])
        boxes.append(box.reshape(bs, -1, 4))
        objs.append(obj.reshape(bs, -1))
        scores.append(torch.where(torch.isfinite(sc), sc, 0.0)
                      .reshape(bs, -1, lyr.nc))
        sizes.append((ny, nx, na))
    return (torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(scores, 1),
            sizes)


def candidates(obj, sizes, conf, top_k, rule):
    """The candidate boxes of one image, the port's two documented rules
    (``ops/nms.py``), with box_k = max(4 * top_k, 256): 'boxes' (the dense
    decode) takes the box_k boxes of highest objectness; 'cells' (the
    sparse decode of the int8 engine's heads) takes, head by head, the
    cells of highest best-anchor objectness, all anchors of each, for a
    quota of max(top_k, box_k * the head's share of the boxes) boxes, then
    the box_k best of these. A box at or under ``conf`` ranks last."""
    n_total = len(obj)
    box_k = min(max(4 * top_k, 256), n_total)
    live = torch.where(obj > conf, obj, 0.0)
    if rule == 'boxes':
        return torch.sort(live, descending=True, stable=True).indices[:box_k]
    idx, at = [], 0
    for ny, nx, na in sizes:
        n_s, n_c = ny * nx * na, ny * nx
        k_c = min(n_c, -(-min(n_s, max(top_k, round(box_k * n_s / n_total)))
                         // na))
        best = live[at:at + n_s].reshape(n_c, na).amax(1)
        cells = torch.sort(best, descending=True, stable=True).indices[:k_c]
        idx.append(at + (cells[:, None] * na + torch.arange(
            na, device=obj.device)).reshape(-1))
        at += n_s
    idx = torch.cat(idx)
    if len(idx) > box_k:
        idx = idx[torch.sort(live[idx], descending=True,
                             stable=True).indices[:box_k]]
    return idx


def iou_matrix(a, b):
    """IoU of xyxy boxes (n, 4) x (m, 4) -> (n, m)."""
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    return inter / (area(a)[:, None] + area(b)[None] - inter + EPS)


def nms(boxes, scores, cand, conf, iou, top_k, max_det):
    """One image: (boxes (N, 4), scores (N, nc)) and its candidate boxes
    ``cand`` -> (d, 6) detections [x1, y1, x2, y2, score, class], best
    first: the candidates' ``top_k`` best pairs above ``conf``, then
    suppression and the merge on boxes offset by their class times 4096
    pixels, as the port's ``ops/nms.py``."""
    nc = scores.shape[1]
    boxes, scores = boxes[cand], scores[cand]
    flat = scores.reshape(-1)
    k = min(top_k, int((flat > conf).sum()))
    if k == 0:
        return torch.zeros((0, 6), device=boxes.device)
    s, idx = torch.topk(flat, k)
    b, c = boxes[idx // nc], (idx % nc).float()
    ob = b + c[:, None] * MAX_WH
    over = iou_matrix(ob, ob) > iou
    keep = torch.zeros(k, dtype=torch.bool)
    alive = torch.ones(k, dtype=torch.bool)
    over_h = over.cpu()
    for i in range(k):                 # greedy, best score first
        if alive[i]:
            keep[i] = True
            alive &= ~over_h[i]
    keep = keep.to(boxes.device)
    w = over.float() * s[None, :]
    merged = (w @ b) / w.sum(1, keepdim=True)
    d = torch.cat([merged, s[:, None], c[:, None]], 1)[keep]
    return d[:max_det]
