"""Box geometry: coordinate transforms and the pairwise IoU.

Counterpart of ``yolo_tpu/ops/boxes.py``; the same expressions in the same
order, so float32 results agree bit for bit where the operations allow it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-16


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the trailing dim of 4."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, *, x1y1x2y2: bool = True,
             GIoU: bool = False, DIoU: bool = False,
             CIoU: bool = False) -> torch.Tensor:
    """Element-wise IoU (or GIoU / DIoU / CIoU) between broadcastable boxes
    on the trailing dim of 4, xyxy or (with ``x1y1x2y2=False``) xywh.

    The eps sits where the JAX package puts it: in the union as
    ``(w1 * h1 + EPS) + w2 * h2 - inter``, in the enclosing area and
    diagonal, and in the CIoU aspect terms; CIoU's alpha is detached."""
    if x1y1x2y2:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    else:
        b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
        b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
        b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
        b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0) *
             (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))

    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1
    union = (w1 * h1 + EPS) + w2 * h2 - inter
    iou = inter / union

    if GIoU or DIoU or CIoU:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
        if GIoU:
            c_area = cw * ch + EPS
            return iou - (c_area - union) / c_area
        c2 = cw ** 2 + ch ** 2 + EPS
        rho2 = (((b2_x1 + b2_x2) - (b1_x1 + b1_x2)) ** 2 / 4 +
                ((b2_y1 + b2_y2) - (b1_y1 + b1_y2)) ** 2 / 4)
        if DIoU:
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * torch.square(
            torch.atan(w2 / (h2 + EPS)) - torch.atan(w1 / (h1 + EPS)))
        alpha = (v / (1 - iou + v + EPS)).detach()
        return iou - (rho2 / c2 + v * alpha)

    return iou


def box_iou_matrix(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4), (..., M, 4) -> (..., N, M).

    The denominator is ``area1 + area2 - inter + EPS`` in that order."""
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:], box2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter + EPS)


def box_iou_matrix_np(box1, box2):
    """Numpy twin of ``box_iou_matrix`` for the host matching loop:
    (N, 4), (M, 4) xyxy -> (N, M), the same eps."""
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + EPS)


def wh_iou(wh1: torch.Tensor, wh2: torch.Tensor) -> torch.Tensor:
    """IoU of width-height pairs with a shared centre: (N, 2), (M, 2) -> (N, M)."""
    wh1 = wh1[:, None]
    wh2 = wh2[None]
    inter = torch.minimum(wh1, wh2).prod(2)
    return inter / (wh1.prod(2) + wh2.prod(2) - inter)


def clip_coords(boxes: torch.Tensor, img_shape) -> torch.Tensor:
    """Clip xyxy boxes to the image bounds (h, w)."""
    h, w = img_shape
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)],
                       -1)


def scale_coords(img1_shape, coords, img0_shape, ratio_pad=None):
    """Rescale xyxy coords from the letterboxed ``img1_shape`` back to
    ``img0_shape``. ``coords`` may be a tensor or a numpy array."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = ((img1_shape[1] - img0_shape[1] * gain) / 2,
               (img1_shape[0] - img0_shape[0] * gain) / 2)
    else:
        gain, pad = ratio_pad[0][0], ratio_pad[1]
    if not torch.is_tensor(coords):
        coords = torch.from_numpy(np.asarray(coords))
    shift = torch.tensor([pad[0], pad[1], pad[0], pad[1]], dtype=coords.dtype,
                         device=coords.device)
    return clip_coords((coords - shift) / gain, img0_shape)
