"""Detection metrics: AP / precision / recall / F1 / fitness (the port's
own copy of ``yolo_tpu/eval/metrics.py``, numpy only).

P/R taken at score 0.1 by interpolation, AP by 101-point COCO
interpolation, fitness = weighted [P, R, mAP, F1] @ [0, 0, 1, 0].
"""

from __future__ import annotations

import numpy as np

from ..ops.boxes import box_iou_matrix_np


def compute_ap(recall, precision):
    """101-point interpolated AP."""
    mrec = np.concatenate(([0.0], recall, [min(recall[-1] + 1e-3, 1.0)]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return np.trapezoid(np.interp(x, mrec, mpre), x)


def ap_per_class(tp, conf, pred_cls, target_cls, pr_score: float = 0.1):
    """Per-class AP from accumulated prediction stats.

    tp: (n, niou) bool; conf, pred_cls: (n,); target_cls: (m,).
    Returns (p, r, ap, f1, unique_classes) with shapes (nc_present, niou)."""
    tp = np.asarray(tp)
    if tp.ndim == 1:                 # niou=1 vector form -> (n, 1)
        tp = tp.reshape(-1, 1)
    conf = np.asarray(conf)
    pred_cls = np.asarray(pred_cls)
    target_cls = np.asarray(target_cls)

    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes = np.unique(target_cls)

    niou = tp.shape[1]
    shape = (len(unique_classes), niou)
    ap, p, r = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_gt = int((target_cls == c).sum())
        n_p = int(sel.sum())
        if n_p == 0 or n_gt == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_gt + 1e-16)
        precision = tpc / (tpc + fpc)
        r[ci] = np.interp(-pr_score, -conf[sel], recall[:, 0])
        p[ci] = np.interp(-pr_score, -conf[sel], precision[:, 0])
        for j in range(niou):
            ap[ci, j] = compute_ap(recall[:, j], precision[:, j])

    f1 = 2 * p * r / (p + r + 1e-16)
    return p, r, ap, f1, unique_classes.astype('int32')


def fitness(x):
    """mAP-weighted fitness used for best-checkpoint selection.
    x: (n, 4) [P, R, mAP, F1]."""
    w = [0.0, 0.0, 1.0, 0.0]
    return (np.asarray(x)[:, :4] * w).sum(1)


def match_predictions(pred, target_cls, target_boxes, iouv):
    """Per-image TP assignment on the host.

    pred: (n, 6) [x1 y1 x2 y2 conf cls]; target_boxes: (m, 4) xyxy pixels.
    Greedy per-class best-IoU matching; each target detected at most once.
    Returns correct: (n, len(iouv)) bool.
    """
    n = len(pred)
    correct = np.zeros((n, len(iouv)), bool)
    if n == 0 or len(target_cls) == 0:
        return correct
    detected: set[int] = set()
    for c in np.unique(target_cls):
        ti = np.nonzero(target_cls == c)[0]
        pi = np.nonzero(pred[:, 5] == c)[0]
        if not len(pi):
            continue
        iou = box_iou_matrix_np(pred[pi, :4], target_boxes[ti])
        best = iou.argmax(1)
        best_iou = iou.max(1)
        for j in np.nonzero(best_iou > iouv[0])[0]:
            d = ti[best[j]]
            if d not in detected:
                detected.add(d)
                correct[pi[j]] = best_iou[j] > iouv
                # all targets of the IMAGE matched: the break counts the
                # image's labels, not the class's
                if len(detected) == len(target_cls):
                    break
    return correct


def coco80_to_coco91_class():
    """80-index (val2014) class ids -> paper 91-index ids: the 91-id range
    with the 11 unused ids removed."""
    skip = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
    return [x for x in range(1, 92) if x not in skip]
