"""The YOLO training loss and one SGD step, in plain PyTorch.

The loss of the reference repository's ``compute_loss`` with GIoU boxes:
every target is matched to each anchor of each head whose width-height
IoU with it exceeds ``iou_t``, at the cell holding its centre; the box
term is 1 - GIoU over the matches, the objectness term a BCE over every
cell against the match's clamped GIoU (where two matches share a cell, the
later in anchor-major order wins), the class term a BCE over the matches'
class scores; each is averaged (objectness over the cells, the others
over the matches, classes also over ``nc``) and weighted by its gain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-9


def giou(p, t):
    """GIoU of xywh boxes, row by row."""
    p1, p2 = p[:, :2] - p[:, 2:] / 2, p[:, :2] + p[:, 2:] / 2
    t1, t2 = t[:, :2] - t[:, 2:] / 2, t[:, :2] + t[:, 2:] / 2
    inter = (torch.minimum(p2, t2) - torch.maximum(p1, t1)).clamp(min=0).prod(1)
    union = (p[:, 2] * p[:, 3] + EPS) + t[:, 2] * t[:, 3] - inter
    c = (torch.maximum(p2, t2) - torch.minimum(p1, t1)).prod(1) + EPS
    return inter / union - (c - union) / c


def bce(logits, labels):
    return -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits))


def yolo_loss(heads, layers, targets, hyp, img_size):
    """heads: NCHW maps; targets: (n, 6) [image, class, x, y, w, h], xywh
    as fractions of the image. Returns (lbox, lobj, lcls, total)."""
    yolos = [l for l in layers if l.kind == 'yolo']
    lbox = lobj = lcls = 0.0
    for h, lyr in zip(heads, yolos):
        bs, _, ny, nx = h.shape
        na, nc = len(lyr.anchors), lyr.nc
        p = h.float().reshape(bs, na, nc + 5, ny, nx).permute(0, 1, 3, 4, 2)
        stride = img_size / ny
        av = torch.tensor(lyr.anchors, device=h.device) / stride      # (na, 2)
        gxy = targets[:, 2:4] * torch.tensor([nx, ny], device=h.device)
        gwh = targets[:, 4:6] * torch.tensor([nx, ny], device=h.device)
        inter = torch.minimum(av[:, None], gwh[None]).prod(2)
        wh_iou = inter / (av.prod(1)[:, None] + gwh.prod(1)[None] - inter)
        a, t = torch.nonzero(wh_iou > hyp['iou_t'], as_tuple=True)  # anchor-major
        b = targets[t, 0].long()
        gij = gxy[t].floor()
        gi, gj = gij[:, 0].long().clamp(0, nx - 1), gij[:, 1].long().clamp(0, ny - 1)
        ps = p[b, a, gj, gi]
        pbox = torch.cat([torch.sigmoid(ps[:, :2]),
                          torch.exp(ps[:, 2:4]).clamp(max=1e3) * av[a]], 1)
        g = giou(pbox, torch.cat([gxy[t] - gij, gwh[t]], 1))
        n = max(len(t), 1)
        lbox = lbox + (1 - g).sum() / n
        # the objectness target of a cell: the last of its matches
        cell = ((b * na + a) * ny + gj) * nx + gi
        last = torch.full((bs * na * ny * nx,), -1, dtype=torch.long,
                          device=h.device)
        last.scatter_reduce_(0, cell, torch.arange(len(t), device=h.device),
                             'amax')
        val = torch.cat([g.detach().clamp(min=0), g.new_zeros(1)])
        tobj = val[last].reshape(p.shape[:4])            # -1: no match
        lobj = lobj + bce(p[..., 4], tobj).mean()
        if nc > 1:
            tcls = F.one_hot(targets[t, 1].long(), nc).float()
            lcls = lcls + bce(ps[:, 5:], tcls).sum() / (n * nc)
    lbox, lobj, lcls = lbox * hyp['giou'], lobj * hyp['obj'], lcls * hyp['cls']
    return lbox, lobj, lcls, lbox + lobj + lcls


def sgd_step(params, grads, momenta, lr, weight_decay, momentum):
    """Nesterov SGD in place: d = g + wd p; v = mu v + d; p -= lr (d + mu v).
    ``lr``/``weight_decay`` map a parameter's field name to its group's."""
    with torch.no_grad():
        for key, p in params.items():
            field = key.split('.')[1]
            d = grads[key] + weight_decay(field) * p
            v = momenta[key] = momentum * momenta.get(key, torch.zeros_like(p)) + d
            p -= lr(field) * (d + momentum * v)


EMA_DECAY, EMA_RAMP = 0.9999, 2000.0


def ema_step(ema, current, t):
    """The moving average after update ``t`` (1, 2, ...): e = d e + (1 - d)
    m with the decay ramped as d = 0.9999 (1 - exp(-t / 2000)), over every
    leaf of ``current`` (dicts of tensors), in place on ``ema``."""
    d = EMA_DECAY * (1.0 - math.exp(-t / EMA_RAMP))
    with torch.no_grad():
        for key, m in current.items():
            ema[key].mul_(d).add_(m.detach(), alpha=1.0 - d)
