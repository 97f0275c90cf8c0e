"""Host-side image transforms of the detection CLI (the port's copy of
``letterbox`` from ``yolo_tpu/data/transforms.py``). OpenCV is imported
inside the function only."""

from __future__ import annotations

import numpy as np

PAD_VALUE = 114  # grey padding


def letterbox(img, new_shape=(416, 416), color=(PAD_VALUE,) * 3, auto=True,
              scale_fill=False, scaleup=True, is_gray_scale=False):
    """Pad-resize to a rectangle.

    auto=True pads only to the next 64-multiple (minimum rectangle);
    returns (img, (rw, rh), (dw, dh))."""
    import cv2
    shape = img.shape[:2]
    if isinstance(new_shape, (int, np.integer)):
        new_shape = (int(new_shape), int(new_shape))

    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)

    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % 64, dh % 64
    elif scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])

    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
        if is_gray_scale and img.ndim == 2:
            img = img[..., None]
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right,
                             cv2.BORDER_CONSTANT, value=color)
    if is_gray_scale and img.ndim == 2:
        img = img[..., None]
    return img, ratio, (dw, dh)
