"""Box drawing of the detection CLI (the port's copy of ``plot_one_box`` and
``color_for_class`` from ``yolo_tpu/utils/plots.py``). OpenCV is imported
inside the function only."""

from __future__ import annotations

import random


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
