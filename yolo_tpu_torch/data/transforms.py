"""Host-side image transforms (the port's copy of ``letterbox``,
``resize_to``, ``xyxy2xywh_np`` and ``xywhn_to_xyxy_pixels`` from
``yolo_tpu/data/transforms.py``): the detection CLI's letterbox and the
evaluation dataset's resize and label math. OpenCV is imported inside the
functions only. The training augmentations (``augment_hsv``,
``random_affine``, ``cutout``, ``bbox_ioa``) are not ported yet (see
ROADMAP.md)."""

from __future__ import annotations

import numpy as np

PAD_VALUE = 114  # grey padding


def resize_to(img: np.ndarray, img_size: int, augment: bool,
              is_gray_scale: bool = False):
    """Aspect-preserving resize so that the longer side is ``img_size``
    (only down, unless ``augment``); returns (img, (h0, w0), (h, w))."""
    h0, w0 = img.shape[:2]
    r = img_size / max(h0, w0)
    if r < 1 or (augment and r != 1):
        import cv2
        interp = cv2.INTER_AREA if (r < 1 and not augment) else cv2.INTER_LINEAR
        img = cv2.resize(img, (int(w0 * r), int(h0 * r)), interpolation=interp)
        if is_gray_scale and img.ndim == 2:
            img = img[..., None]
    return img, (h0, w0), img.shape[:2]


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


def xyxy2xywh_np(x):
    y = np.copy(x)
    y[..., 0] = (x[..., 0] + x[..., 2]) / 2
    y[..., 1] = (x[..., 1] + x[..., 3]) / 2
    y[..., 2] = x[..., 2] - x[..., 0]
    y[..., 3] = x[..., 3] - x[..., 1]
    return y


def xywhn_to_xyxy_pixels(labels, w, h, padw=0.0, padh=0.0, rw=1.0, rh=1.0):
    """(n, 5) [cls, normalised xywh] labels -> [cls, pixel xyxy] with the
    letterbox ratio and padding applied."""
    out = labels.copy()
    out[:, 1] = rw * w * (labels[:, 1] - labels[:, 3] / 2) + padw
    out[:, 2] = rh * h * (labels[:, 2] - labels[:, 4] / 2) + padh
    out[:, 3] = rw * w * (labels[:, 1] + labels[:, 3] / 2) + padw
    out[:, 4] = rh * h * (labels[:, 2] + labels[:, 4] / 2) + padh
    return out
