"""Box drawing (the port's copy of ``plot_one_box``, ``color_for_class``
and ``plot_images`` from ``yolo_tpu/utils/plots.py``): the detection CLI's
boxes and the evaluator's batch mosaics. OpenCV is imported inside the
functions only."""

from __future__ import annotations

import random

import numpy as np


def color_for_class(c: int):
    rnd = random.Random(c)
    return [rnd.randint(0, 255) for _ in range(3)]


def plot_one_box(xyxy, img, color=None, label=None, line_thickness=None):
    """Draw one box (and its label) on a BGR image in place."""
    import cv2
    tl = line_thickness or round(0.002 * (img.shape[0] + img.shape[1]) / 2) + 1
    color = color or [random.randint(0, 255) for _ in range(3)]
    c1, c2 = (int(xyxy[0]), int(xyxy[1])), (int(xyxy[2]), int(xyxy[3]))
    cv2.rectangle(img, c1, c2, color, thickness=tl, lineType=cv2.LINE_AA)
    if label:
        tf = max(tl - 1, 1)
        t_size = cv2.getTextSize(label, 0, fontScale=tl / 3, thickness=tf)[0]
        c2 = c1[0] + t_size[0], c1[1] - t_size[1] - 3
        cv2.rectangle(img, c1, c2, color, -1, cv2.LINE_AA)
        cv2.putText(img, label, (c1[0], c1[1] - 2), 0, tl / 3, [225, 255, 255],
                    thickness=tf, lineType=cv2.LINE_AA)
    return img


def plot_images(images, targets, paths=None, fname='images.jpg', names=None,
                max_size=640, max_subplots=16):
    """Batch mosaic with target boxes, written to ``fname`` (BGR) when
    given; returns the mosaic RGB.

    images: (bs, h, w, c) uint8 RGB; targets: (n, 6) [img, cls, xywh norm]."""
    import cv2
    bs = min(len(images), max_subplots)
    h, w = images.shape[1:3]
    ns = int(np.ceil(bs ** 0.5))
    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        r, c = divmod(i, ns)
        img = images[i]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        mosaic[r * h:(r + 1) * h, c * w:(c + 1) * w] = img[..., ::-1]  # ->BGR
        t = targets[targets[:, 0] == i]
        for row in t:
            cls = int(row[1])
            cx, cy, bw, bh = row[2] * w, row[3] * h, row[4] * w, row[5] * h
            xyxy = (c * w + cx - bw / 2, r * h + cy - bh / 2,
                    c * w + cx + bw / 2, r * h + cy + bh / 2)
            label = names[cls] if names and cls < len(names) else str(cls)
            plot_one_box(xyxy, mosaic, color=color_for_class(cls), label=label)
    scale = max_size / max(mosaic.shape[:2])
    if scale < 1:
        mosaic = cv2.resize(mosaic, (int(mosaic.shape[1] * scale),
                                     int(mosaic.shape[0] * scale)))
    if fname:
        cv2.imwrite(fname, mosaic)
    return mosaic[..., ::-1]
