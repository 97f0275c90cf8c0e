"""Device-side TP assignment for evaluation (counterpart of
yolo_tpu/eval/matching.py).

The host loop (``metrics.match_predictions``) matches predictions to
targets image by image and class by class. Here the same greedy claim runs
batched over the images, on the batch's device:

  - predictions are taken in NMS output order (conf descending);
  - each prediction's candidate is the best-IoU target of its own image and
    class: its argmax, taken before any claim is made (the first index
    among ties, as ``jnp.argmax`` and ``torch.argmax`` both return);
  - a target is won by the first eligible prediction whose candidate it
    is (one ``scatter_reduce_('amin')`` of the row index per target); a
    prediction whose candidate is already claimed gets nothing, not its
    second best;
  - correct[b, i, j] = claimed & best_iou > iouv[j].

No value is read back to the host and none is copied from it, so the
matcher queues behind the batch's forward and NMS without a synchronise.
"""

from __future__ import annotations

import torch

from ..ops.boxes import box_iou_matrix, xywh2xyxy


def match_device(dets, targets, valid, w: float, h: float,
                 iouv: tuple = (0.5,)):
    """Batched TP matrix.

    dets: (bs, max_det, 6) NMS output [x1 y1 x2 y2 conf cls] (conf == 0
    pads); targets: (T, 6) [img, cls, x, y, w, h] normalised; valid: (T,)
    bool. Returns correct: (bs, max_det, len(iouv)) bool, rows aligned with
    dets."""
    bs, max_det = dets.shape[:2]
    if targets.shape[0] == 0:
        return torch.zeros((bs, max_det, len(iouv)), dtype=torch.bool,
                           device=dets.device)
    t = targets[:, 2:6]
    tbox = xywh2xyxy(torch.stack([t[:, 0] * w, t[:, 1] * h, t[:, 2] * w,
                                  t[:, 3] * h], -1))             # (T, 4) pixels
    tcls = targets[:, 1]
    timg = targets[:, 0].to(torch.int32)

    boxes = torch.stack([dets[..., 0].clamp(0, w), dets[..., 1].clamp(0, h),
                         dets[..., 2].clamp(0, w), dets[..., 3].clamp(0, h)],
                        -1)
    conf, pcls = dets[..., 4], dets[..., 5]
    iou = box_iou_matrix(boxes, tbox[None])                  # (bs, max_det, T)
    img = torch.arange(bs, dtype=torch.int32, device=dets.device)
    ok = valid[None, :] & (timg[None, :] == img[:, None])    # (bs, T)
    iou = torch.where(ok[:, None, :] & (pcls[..., None] == tcls),
                      iou, -1.0)

    best = iou.argmax(2)                                     # (bs, max_det)
    biou = iou.gather(2, best[..., None])[..., 0]
    eligible = (biou > iouv[0]) & (conf > 0)
    idx = torch.arange(max_det, device=dets.device).expand(bs, max_det)
    cand = torch.where(eligible, idx, max_det)
    first = torch.full((bs, targets.shape[0]), max_det, dtype=idx.dtype,
                       device=dets.device)
    first.scatter_reduce_(1, best, cand, 'amin')
    claim = eligible & (first.gather(1, best) == idx)
    return claim[..., None] & torch.stack([biou > v for v in iouv], -1)
