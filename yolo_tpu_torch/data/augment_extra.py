"""FenceMask and GridMask, occlusion augmentations on host batches (the
port's copy of ``yolo_tpu/data/augment_extra.py``; no loader calls them).

FenceMask's masks are fixed random masks, pre-generated in groups.
FenceMask draws from the ``random.Random`` it is given and from
``np.random``, GridMask from the ``np.random.Generator`` it is given, in
the JAX package's order, so the same seeds give the same masks. OpenCV is
imported inside the functions only.
"""

from __future__ import annotations

import math
import random

import numpy as np


class FenceMask:
    """Random fence-stripe occlusion masks, ``group_size`` groups of
    ``batch_size`` made at construction. Call on a float NHWC batch."""

    def __init__(self, batch_size: int, img_size: int, probability: float,
                 group_size: int = 10, rng=None):
        self.rnd = rng or random.Random()
        self.img_size = img_size
        self.batch_size = batch_size
        self.group_size = group_size
        self.st_prob = self.prob = probability
        self.group_masks = [
            np.stack([self._one_mask() for _ in range(batch_size)])
            for _ in range(group_size)
        ]

    def _one_mask(self):
        import cv2
        s = self.img_size
        x = self.rnd.randint(s // 32, s // 16)
        y = self.rnd.randint(s // 32, s // 16)
        l1 = self.rnd.randint(s // 16, s // 8)
        l2 = self.rnd.randint(s // 16, s // 8)
        m1 = np.ones((s, s), np.float32)
        m2 = np.ones((s, s), np.float32)
        for i in range(1, s // (l1 + x) + 1):
            m1[i * l1 + (i - 1) * x:i * (l1 + x), :] = 0
        for i in range(1, s // (l2 + y) + 1):
            m2[:, i * l2 + (i - 1) * y:i * (l2 + y)] = 0
        center = (s / 2, s / 2)
        r1 = cv2.getRotationMatrix2D(center, self.rnd.randint(0, 360), 2)
        r2 = cv2.getRotationMatrix2D(center, self.rnd.randint(0, 360), 2)
        m1 = cv2.warpAffine(m1, r1, (s, s))
        m2 = cv2.warpAffine(m2, r2, (s, s))
        mask = (m1 * m2)[..., None]                       # (s, s, 1)
        # grey-noise fill: bright on kept pixels, dark on masked
        noise_w = (0.5 * np.random.rand(s, s, 1) + 0.5) * mask
        noise_b = (0.5 * np.random.rand(s, s, 1)) * (1 - mask)
        return (noise_w + noise_b).astype(np.float32)

    def set_prob(self, epoch: int, max_epoch: int):
        self.prob = self.st_prob * min(1, epoch / max_epoch)

    def __call__(self, x: np.ndarray):
        """x: (bs, h, w, c) float in [0,1]. Returns (x_masked, masks|None)."""
        if self.rnd.uniform(0, 1) > self.prob:
            return x, None
        if x.shape[0] != self.batch_size:
            return x, None
        masks = self.group_masks[self.rnd.randrange(self.group_size)]
        return x * masks, masks


class GridMask:
    """GridMask occlusion: a regular grid of squares at a random offset
    and rotation; mode 1 inverts the mask."""

    def __init__(self, d1: int, d2: int, rotate: int = 1, ratio: float = 0.5,
                 mode: int = 0, prob: float = 1.0, rng=None):
        self.d1, self.d2 = d1, d2
        self.rotate = rotate
        self.ratio = ratio
        self.mode = mode
        self.st_prob = self.prob = prob
        self.rng = rng or np.random.default_rng()

    def set_prob(self, epoch: int, max_epoch: int):
        self.prob = self.st_prob * min(1, epoch / max_epoch)

    def __call__(self, img: np.ndarray):
        """img: (h, w, c). Returns masked image."""
        import cv2
        if self.rng.random() > self.prob:
            return img
        h, w = img.shape[:2]
        hh = math.ceil(math.sqrt(h * h + w * w))
        d = int(self.rng.integers(self.d1, self.d2))
        l = math.ceil(d * self.ratio)
        mask = np.ones((hh, hh), np.float32)
        st_h = int(self.rng.integers(d))
        st_w = int(self.rng.integers(d))
        for i in range(-1, hh // d + 1):
            s = max(min(d * i + st_h, hh), 0)
            t = max(min(d * i + st_h + l, hh), 0)
            mask[s:t, :] = 0
        for i in range(-1, hh // d + 1):
            s = max(min(d * i + st_w, hh), 0)
            t = max(min(d * i + st_w + l, hh), 0)
            mask[:, s:t] = 0
        if self.rotate > 1:
            angle = int(self.rng.integers(self.rotate))
            M = cv2.getRotationMatrix2D((hh / 2, hh / 2), angle, 1)
            mask = cv2.warpAffine(mask, M, (hh, hh))
        mask = mask[(hh - h) // 2:(hh - h) // 2 + h,
                    (hh - w) // 2:(hh - w) // 2 + w]
        if self.mode == 1:
            mask = 1 - mask
        return img * mask[..., None]
