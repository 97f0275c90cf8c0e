"""Host-side image transforms (the port's copy of
``yolo_tpu/data/transforms.py``): the letterbox and resize of the
detection CLI and the datasets, the label math, and the training
augmentations (``augment_hsv``, ``random_affine``, ``bbox_ioa``,
``cutout``). OpenCV is imported inside the functions only. Every random
draw goes through the ``random.Random`` passed in, in the JAX package's
order, so that the same seed gives the same pixels and labels."""

from __future__ import annotations

import math
import random

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


def augment_hsv(img, hgain=0.5, sgain=0.5, vgain=0.5,
                rnd: random.Random | None = None):
    """In-place HSV jitter of a BGR uint8 image through lookup tables: one
    gain per channel, ``1 + U(-1, 1) * gain``."""
    import cv2
    rnd = rnd or random
    gains = np.array([rnd.uniform(-1, 1) for _ in range(3)]) * \
        [hgain, sgain, vgain] + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(256, dtype=np.int16)
    lut_h = ((x * gains[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * gains[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * gains[2], 0, 255).astype(img.dtype)
    hsv = cv2.merge((cv2.LUT(hue, lut_h), cv2.LUT(sat, lut_s),
                     cv2.LUT(val, lut_v)))
    cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR, dst=img)
    return img


def random_affine(img, targets=None, degrees=10, translate=.1, scale=.1,
                  shear=10, border=0, rnd: random.Random | None = None):
    """Rotation, scale, translation and shear in one warp, and the boxes
    through it: those left under 4 px a side, under a fifth of their
    scaled area or with an aspect over 10 are dropped. ``targets`` (n, 5)
    [cls, x1, y1, x2, y2] pixels; ``border`` < 0 crops (the mosaic's
    2s canvas back to s). Returns (img, targets f32)."""
    import cv2
    rnd = rnd or random
    targets = np.zeros((0, 5), np.float32) if targets is None or not len(targets) \
        else np.asarray(targets, np.float64)
    height = img.shape[0] + border * 2
    width = img.shape[1] + border * 2

    a = rnd.uniform(-degrees, degrees)
    s = rnd.uniform(1 - scale, 1 + scale)
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(img.shape[1] / 2,
                                                     img.shape[0] / 2), scale=s)
    T = np.eye(3)
    T[0, 2] = rnd.uniform(-translate, translate) * img.shape[0] + border
    T[1, 2] = rnd.uniform(-translate, translate) * img.shape[1] + border
    S = np.eye(3)
    S[0, 1] = math.tan(rnd.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rnd.uniform(-shear, shear) * math.pi / 180)

    M = S @ T @ R
    if border != 0 or (M != np.eye(3)).any():
        gray = img.ndim == 3 and img.shape[2] == 1
        img = cv2.warpAffine(img, M[:2], dsize=(width, height),
                             flags=cv2.INTER_LINEAR,
                             borderValue=(PAD_VALUE,) * 3)
        if gray and img.ndim == 2:
            img = img[..., None]        # cv2 drops a singleton channel

    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = (xy @ M.T)[:, :2].reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        boxes = np.stack((x.min(1), y.min(1), x.max(1), y.max(1)), axis=1)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, width)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, height)
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        area = w * h
        area0 = (targets[:, 3] - targets[:, 1]) * (targets[:, 4] - targets[:, 2])
        ar = np.maximum(w / (h + 1e-16), h / (w + 1e-16))
        keep = (w > 4) & (h > 4) & (area / (area0 * s + 1e-16) > 0.2) & (ar < 10)
        targets = targets[keep]
        targets[:, 1:5] = boxes[keep]

    return img, targets.astype(np.float32)


def bbox_ioa(box, boxes):
    """Intersection of ``box`` (4,) over the area of each of ``boxes``
    (n, 4), xyxy."""
    boxes = np.asarray(boxes, np.float32)
    iw = (np.minimum(box[2], boxes[:, 2]) -
          np.maximum(box[0], boxes[:, 0])).clip(0)
    ih = (np.minimum(box[3], boxes[:, 3]) -
          np.maximum(box[1], boxes[:, 1])).clip(0)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) + 1e-16
    return iw * ih / area


def cutout(image, labels, rnd: random.Random | None = None):
    """Random erasing: 31 grey-noise rectangles in a 1/2 ... 1/32 size
    pyramid painted over ``image`` in place; labels ((n, 5) [cls, xyxy]
    pixels) more than 60% covered by a rectangle of scale > 0.03 are
    dropped. Returns the labels kept."""
    rnd = rnd or random
    h, w = image.shape[:2]
    scales = ([0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 +
              [0.03125] * 16)
    for s in scales:
        mask_h = rnd.randint(1, max(int(h * s), 1))
        mask_w = rnd.randint(1, max(int(w * s), 1))
        xmin = max(0, rnd.randint(0, w) - mask_w // 2)
        ymin = max(0, rnd.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        image[ymin:ymax, xmin:xmax] = [rnd.randint(64, 191)
                                       for _ in range(image.shape[2])]
        if len(labels) and s > 0.03:
            ioa = bbox_ioa(np.array([xmin, ymin, xmax, ymax], np.float32),
                           labels[:, 1:5])
            labels = labels[ioa < 0.60]
    return labels
