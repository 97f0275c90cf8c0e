"""Image sources of the port (copies from ``yolo_tpu/data/datasets.py``).

- ``LoadImages``: the detection CLI's image and video source.
- ``DetectionDataset``: an image-list txt with its label txt files, the
  label cache and its validation, rectangular batching by aspect ratio
  (the ``.shapes`` sidecar), ``subset_len`` sampling, the letterbox and
  the label math; for training, ``augment=True`` with ``hyp``: the
  4-image mosaic, ``random_affine``, ``augment_hsv``, the left-right flip
  and, when asked, the up-down flip and ``cutout``; ``image_weights=True``
  with ``update_image_weights``.
- ``BatchLoader``: fixed-shape batches (uint8 NHWC images, capacity-padded
  targets and their mask, paths, shapes) from a background prefetch
  thread; a ragged tail is padded with empty images and empty paths.
  Training takes ``shuffle``, ``drop_last`` and ``seed``.

Every random draw of the augmentations goes through the dataset's
``random.Random(seed)`` (the batch order through the loader's), in the JAX
package's order, and one prefetch thread draws them in batch order, so a
seed gives the JAX package's batches bit for bit. OpenCV and PIL are
imported inside the functions only. Not ported yet (see ROADMAP.md):
``process_shard`` (the multi-host split) and the JAX package's native C++
batch letterbox.
"""

from __future__ import annotations

import glob
import math
import os
import queue
import random
import threading
from pathlib import Path

import numpy as np

from ..compress.quant import unported
from .transforms import (PAD_VALUE, augment_hsv, cutout, letterbox,
                         random_affine, resize_to, xywhn_to_xyxy_pixels,
                         xyxy2xywh_np)

IMG_FORMATS = ['.bmp', '.jpg', '.jpeg', '.png', '.tif', '.dng']
VID_FORMATS = ['.mov', '.avi', '.mp4']


def _read_image(path: str, is_gray_scale: bool = False) -> np.ndarray:
    import cv2
    if is_gray_scale:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        img = None if img is None else img[..., None]
    else:
        img = cv2.imread(path)  # BGR
    if img is None:
        raise FileNotFoundError(f'Image Not Found {path}')
    return img


class LoadImages:
    """Directory/file image+video source.

    Iterates (path, letterboxed_img_chw_rgb, original_img, video_capture).
    ``rect=False`` letterboxes to the full square (one static shape);
    ``rect=True`` pads to the minimal 64-multiple rectangle."""

    def __init__(self, path, img_size=416, is_gray_scale=False, rect=False):
        self.rect = rect
        path = str(Path(path))
        files = []
        if os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, '*.*')))
        elif os.path.isfile(path):
            files = [path]
        images = [f for f in files if os.path.splitext(f)[-1].lower() in IMG_FORMATS]
        videos = [f for f in files if os.path.splitext(f)[-1].lower() in VID_FORMATS]
        self.img_size = img_size
        self.files = images + videos
        self.n_images = len(images)
        self.video_flag = [False] * len(images) + [True] * len(videos)
        self.mode = 'images'
        self.is_gray_scale = is_gray_scale
        self.cap = None
        if not self.files:
            raise FileNotFoundError(f'No images or videos found in {path}')
        if videos:
            self._new_video(videos[0])

    def __iter__(self):
        self.count = 0
        return self

    def __len__(self):
        return len(self.files)

    def _new_video(self, path):
        import cv2
        self.frame = 0
        self.cap = cv2.VideoCapture(path)
        self.nframes = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def __next__(self):
        if self.count == len(self.files):
            raise StopIteration
        path = self.files[self.count]
        if self.video_flag[self.count]:
            self.mode = 'video'
            ok, img0 = self.cap.read()
            if not ok:
                self.count += 1
                self.cap.release()
                if self.count == len(self.files):
                    raise StopIteration
                path = self.files[self.count]
                self._new_video(path)
                ok, img0 = self.cap.read()
            self.frame += 1
        else:
            self.count += 1
            img0 = _read_image(path, self.is_gray_scale)
        img = letterbox(img0, new_shape=self.img_size, auto=self.rect,
                        is_gray_scale=self.is_gray_scale)[0]
        if not self.is_gray_scale:
            img = img[:, :, ::-1]  # BGR -> RGB
        img = np.ascontiguousarray(img.transpose(2, 0, 1))
        return path, img, img0, self.cap


class DetectionDataset:
    """Dataset over an image-list txt; labels are read from the sibling
    ``labels/`` txt of each image (``images`` -> ``labels``)."""

    def __init__(self, path, img_size=416, batch_size=16, augment=False,
                 hyp=None, rect=False, image_weights=False,
                 cache_images=False, is_gray_scale=False, subset_len=-1,
                 seed=None, process_shard=None, cutout=False,
                 ud_flip=False):
        if process_shard is not None:
            raise unported('DetectionDataset(process_shard=...) (multi-host '
                            'evaluation)')
        path = str(Path(path))
        if not os.path.isfile(path):
            raise FileNotFoundError(f'File not found {path}')
        with open(path) as f:
            self.img_files = [x for x in f.read().splitlines()
                              if os.path.splitext(x)[-1].lower() in IMG_FORMATS]
        self.rnd = random.Random(seed)
        if subset_len != -1:
            if subset_len > len(self.img_files):
                raise ValueError(f'subset_len {subset_len} > '
                                 f'{len(self.img_files)} images')
            keep = self.rnd.sample(range(len(self.img_files)), subset_len)
            self.img_files = [self.img_files[i] for i in keep]
        n = len(self.img_files)
        if n == 0:
            raise FileNotFoundError(f'No images found in {path}')
        bi = np.floor(np.arange(n) / batch_size).astype(int)

        self.n = n
        self.batch = bi
        self.img_size = img_size
        self.augment = augment
        self.hyp = hyp or {}
        self.image_weights = image_weights
        self.rect = False if image_weights else rect
        self.mosaic = self.augment and not self.rect
        self.is_gray_scale = is_gray_scale
        self.cutout = cutout
        self.ud_flip = ud_flip
        self.indices = list(range(n))

        self.label_files = [
            x.replace('images', 'labels').replace(os.path.splitext(x)[-1], '.txt')
            for x in self.img_files]

        if self.rect:
            shapes = self._read_shapes(path)
            ar = shapes[:, 1] / shapes[:, 0]  # h / w; shapes are (w, h)
            order = ar.argsort()
            self.img_files = [self.img_files[i] for i in order]
            self.label_files = [self.label_files[i] for i in order]
            self.shapes = shapes[order]
            ar = ar[order]
            nb = bi[-1] + 1
            batch_shapes = [[1, 1]] * nb
            for b in range(nb):
                ari = ar[bi == b]
                mini, maxi = ari.min(), ari.max()
                if maxi < 1:
                    batch_shapes[b] = [maxi, 1]
                elif mini > 1:
                    batch_shapes[b] = [1, 1 / mini]
            self.batch_shapes = (np.ceil(np.array(batch_shapes) * img_size / 32.)
                                 .astype(int) * 32)

        # label cache and validation
        self.labels = [np.zeros((0, 5), np.float32)] * n
        n_missing = n_found = n_empty = n_dup = 0
        for i, lf in enumerate(self.label_files):
            try:
                with open(lf) as f:
                    lab = np.array([x.split() for x in f.read().splitlines()],
                                   dtype=np.float32)
            except (OSError, ValueError):
                n_missing += 1
                continue
            if lab.shape[0]:
                if lab.shape[1] != 5:
                    raise ValueError(f'> 5 label columns: {lf}')
                if not (lab >= 0).all():
                    raise ValueError(f'negative labels: {lf}')
                if not (lab[:, 1:] <= 1).all():
                    raise ValueError('non-normalized or out of bounds '
                                     f'coordinate labels: {lf}')
                if np.unique(lab, axis=0).shape[0] < lab.shape[0]:
                    n_dup += 1
                self.labels[i] = lab
                n_found += 1
            else:
                n_empty += 1
        self.stats = dict(found=n_found, missing=n_missing, empty=n_empty,
                          duplicate=n_dup)

        self.imgs = [None] * n
        self.img_hw0 = [None] * n
        self.img_hw = [None] * n
        if cache_images:
            for i in range(n):
                self._load_image(i)

    def path_of(self, index):
        """Image path for the batch metadata."""
        return self.img_files[index]

    def _read_shapes(self, path):
        """(w, h) of every image, from the ``.shapes`` sidecar of the list
        file when it is in sync, else read with PIL and written there."""
        sp = path.replace('.txt', '.shapes')
        try:
            with open(sp) as f:
                s = [x.split() for x in f.read().splitlines()]
            if len(s) == self.n:
                return np.array(s, np.float64)
        except OSError:
            pass
        from PIL import Image
        shapes = []
        for f in self.img_files:
            with Image.open(f) as im:
                shapes.append(im.size)  # (w, h)
        s = np.array(shapes, np.float64)
        try:
            np.savetxt(sp, s, fmt='%g')
        except OSError:
            pass
        return s

    def _load_image(self, index):
        if self.imgs[index] is not None:
            return self.imgs[index], self.img_hw0[index], self.img_hw[index]
        img = _read_image(self.img_files[index], self.is_gray_scale)
        img, hw0, hw = resize_to(img, self.img_size, self.augment,
                                 self.is_gray_scale)
        self.imgs[index], self.img_hw0[index], self.img_hw[index] = img, hw0, hw
        return img, hw0, hw

    def _affine_kw(self):
        h = self.hyp
        return dict(degrees=h.get('degrees', 0), translate=h.get('translate', 0),
                    scale=h.get('scale', 0), shear=h.get('shear', 0))

    def _load_mosaic(self, index):
        """The 4-image mosaic: ``index`` and three random images around a
        random centre of a 2s x 2s grey canvas, their labels moved with
        them, then ``random_affine`` with a -s/2 border (back to s x s).
        Returns (img BGR, labels (n, 5) [cls, xyxy] pixels)."""
        s = self.img_size
        xc = int(self.rnd.uniform(s * 0.5, s * 1.5))
        yc = int(self.rnd.uniform(s * 0.5, s * 1.5))
        indices = [index] + [self.rnd.randint(0, self.n - 1) for _ in range(3)]
        labels4 = []
        img4 = None
        for i, idx in enumerate(indices):
            img, _, (h, w) = self._load_image(idx)
            if i == 0:      # top left
                img4 = np.full((s * 2, s * 2, img.shape[2]), PAD_VALUE, np.uint8)
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
                x2b, y2b = w, h
            elif i == 1:    # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b = 0, h - (y2a - y1a)
                x2b, y2b = min(w, x2a - x1a), h
            elif i == 2:    # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b = w - (x2a - x1a), 0
                x2b, y2b = max(xc, w), min(y2a - y1a, h)
            else:           # bottom right
                x1a, y1a = xc, yc
                x2a, y2a = min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b = 0, 0
                x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
            img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            lab = self.labels[idx]
            if lab.size:
                labels4.append(xywhn_to_xyxy_pixels(lab, w, h, padw, padh))
        labels4 = (np.concatenate(labels4, 0) if labels4
                   else np.zeros((0, 5), np.float32))
        if len(labels4):
            np.clip(labels4[:, 1:], 0, 2 * s, out=labels4[:, 1:])
        return random_affine(img4, labels4, border=-s // 2, rnd=self.rnd,
                             **self._affine_kw())

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        """(img HWC RGB uint8, labels (n, 5) [cls, xywh normalised], path,
        shapes ((h0, w0), ((h / h0, w / w0), pad)), None for a mosaic)."""
        if self.image_weights:
            index = self.indices[index]
        if self.mosaic:
            img, labels = self._load_mosaic(index)
            shapes = None
        else:
            img, (h0, w0), (h, w) = self._load_image(index)
            shape = (self.batch_shapes[self.batch[index]] if self.rect
                     else self.img_size)
            img, ratio, pad = letterbox(img, shape, auto=False,
                                        scaleup=self.augment,
                                        is_gray_scale=self.is_gray_scale)
            shapes = (h0, w0), ((h / h0, w / w0), pad)
            lab = self.labels[index]
            labels = (xywhn_to_xyxy_pixels(lab, w, h, pad[0], pad[1],
                                           ratio[0], ratio[1])
                      if lab.size else np.zeros((0, 5), np.float32))

        if self.augment:
            if not self.mosaic:
                img, labels = random_affine(img, labels, rnd=self.rnd,
                                            **self._affine_kw())
            if not self.is_gray_scale:
                img = np.ascontiguousarray(img)
                augment_hsv(img, self.hyp.get('hsv_h', 0),
                            self.hyp.get('hsv_s', 0),
                            self.hyp.get('hsv_v', 0), rnd=self.rnd)
            if self.cutout and self.rnd.random() < 0.9:
                img = np.ascontiguousarray(img)
                labels = cutout(img,
                                np.asarray(labels, np.float32).reshape(-1, 5),
                                rnd=self.rnd)

        labels = np.asarray(labels, np.float32).reshape(-1, 5)
        if len(labels):
            labels[:, 1:5] = xyxy2xywh_np(labels[:, 1:5])
            labels[:, [2, 4]] /= img.shape[0]
            labels[:, [1, 3]] /= img.shape[1]

        if self.augment and self.rnd.random() < 0.5:        # left-right
            img = np.fliplr(img)
            if len(labels):
                labels[:, 1] = 1 - labels[:, 1]
        if self.augment and self.ud_flip and self.rnd.random() < 0.5:
            img = np.flipud(img)
            if len(labels):
                labels[:, 2] = 1 - labels[:, 2]

        if not self.is_gray_scale:
            img = img[:, :, ::-1]  # BGR -> RGB, HWC
        return np.ascontiguousarray(img), labels, self.path_of(index), shapes

    def class_weights(self, nc):
        """Inverse-frequency class weights."""
        counts = np.bincount(
            np.concatenate([l[:, 0].astype(int) for l in self.labels
                            if len(l)] or [np.zeros(0, int)]), minlength=nc)
        w = 1.0 / np.maximum(counts, 1)
        return w / w.sum()

    def update_image_weights(self, nc, maps):
        """Image-weighted resampling indices from the per-class mAPs: each
        image drawn with the weight of its labels' classes, a class
        weighing its inverse frequency times (1 - its mAP)^2, from a fresh
        unseeded generator, as in the JAX package."""
        cw = self.class_weights(nc) * (1 - maps) ** 2
        iw = np.array([
            (np.bincount(l[:, 0].astype(int), minlength=nc) * cw).sum()
            for l in self.labels])
        tot = iw.sum()
        probs = iw / tot if tot > 0 else None
        rng = np.random.default_rng()
        self.indices = list(rng.choice(self.n, self.n, p=probs)) \
            if probs is not None else list(range(self.n))


class BatchLoader:
    """Fixed-shape batch assembler with a background prefetch thread.

    Yields (imgs (bs, H, W, C) uint8, targets (max_t, 6), valid (max_t,),
    paths, shapes), numpy; a ragged tail is padded to ``batch_size`` with
    zero images, no labels and empty paths."""

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 max_targets: int = 0, shuffle: bool = False,
                 prefetch: int = 2, drop_last: bool = False, seed=None):
        self.ds = dataset
        self.bs = batch_size
        self.max_t = max_targets or (30 * batch_size)
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rnd = random.Random(seed)

    def __len__(self):
        if self.drop_last:
            return self.ds.n // self.bs
        return math.ceil(self.ds.n / self.bs)

    def _assemble(self, idxs):
        from ..train.loss import pad_targets
        imgs, labels, paths, shapes = [], [], [], []
        for i in idxs:
            im, lab, p, sh = self.ds[i]
            imgs.append(im)
            labels.append(lab)
            paths.append(p)
            shapes.append(sh)
        while len(imgs) < self.bs:
            imgs.append(np.zeros_like(imgs[0]))
            labels.append(np.zeros((0, 5), np.float32))
            paths.append('')
            shapes.append(None)
        tgt, valid = pad_targets(labels, self.max_t)
        return np.stack(imgs), tgt, valid, paths, shapes

    def __iter__(self):
        order = list(range(self.ds.n))
        if self.shuffle and not self.ds.rect:
            self.rnd.shuffle(order)
        batches = [order[i:i + self.bs] for i in range(0, len(order), self.bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.bs]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        error = []

        def producer():
            try:
                for b in batches:
                    q.put(self._assemble(b))
            except Exception as e:     # re-raised in the consumer
                error.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if error:
            raise error[0]
