"""Box geometry: coordinate transforms and the pairwise IoU.

Counterpart of ``yolo_tpu/ops/boxes.py``; the same expressions in the same
order, so float32 results agree bit for bit where the operations allow it.
``bbox_iou`` and ``wh_iou`` belong to the training slice and are not here.
"""

from __future__ import annotations

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
