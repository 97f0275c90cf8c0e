"""Image sources of the port (copies from ``yolo_tpu/data/datasets.py``).

- ``LoadImages``: the detection CLI's image and video source.
- ``LoadWebcam`` (a local camera) and ``LoadStreams`` (RTSP/HTTP URLs, a
  video file, or a ``.txt`` listing them, one reader thread a source): the
  detection CLI's live sources.
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
  Training takes ``shuffle``, ``drop_last`` and ``seed``. Batches that are
  neither augmented nor gray are letterboxed by the host library
  (``native.letterbox_batch``, one OpenMP pass a batch) when it builds, as
  the JAX package's loader does.

Every random draw of the augmentations goes through the dataset's
``random.Random(seed)`` (the batch order through the loader's), in the JAX
package's order, and one prefetch thread draws them in batch order, so a
seed gives the JAX package's batches bit for bit. OpenCV and PIL are
imported inside the functions only.

``process_shard=(pi, pc)`` is one rank's part of a data-parallel job (the
reference's ``DistributedSampler``): every pc-th file from pi, wrap-padded
with its own first files to ``ceil(n / pc)`` so that every rank has the
same number of batches; ``path_of`` gives '' for a pad, which the
evaluator then counts as it counts a ragged batch's empty slot.
"""

from __future__ import annotations

import glob
import math
import os
import queue
import random
import threading
import time
from pathlib import Path

import numpy as np

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


def _quit_pressed() -> bool:
    """'q' pressed in an OpenCV window. A build without a window system
    has no keys to read."""
    import cv2
    try:
        return cv2.waitKey(1) == ord('q')
    except cv2.error:
        return False


def _close_windows():
    import cv2
    try:
        cv2.destroyAllWindows()
    except cv2.error:
        pass


class LoadWebcam:
    """A local camera (``pipe`` 0, mirrored) or any capture source, one
    frame a step until 'q'. Iterates ('webcam.jpg', letterboxed CHW RGB,
    the BGR frame, None)."""

    def __init__(self, pipe=0, img_size=416):
        import cv2
        self.img_size = img_size
        self.pipe = pipe
        self.cap = cv2.VideoCapture(pipe)
        self.cap.set(cv2.CAP_PROP_BUFFERSIZE, 3)
        self.mode = 'webcam'

    def __iter__(self):
        self.count = -1
        return self

    def __len__(self):
        return 0

    def __next__(self):
        import cv2
        self.count += 1
        if _quit_pressed():
            self.cap.release()
            _close_windows()
            raise StopIteration
        ok, img0 = self.cap.read()
        if not ok:
            raise RuntimeError(f'Camera Error {self.pipe}')
        if self.pipe == 0:
            img0 = cv2.flip(img0, 1)  # mirror the local webcam
        img = letterbox(img0, new_shape=self.img_size)[0]
        img = np.ascontiguousarray(img[:, :, ::-1].transpose(2, 0, 1))
        return 'webcam.jpg', img, img0, None


class LoadStreams:
    """Live sources read by one daemon thread each: ``sources`` is a
    ``.txt`` listing one source a line, or one source ('0' a local camera,
    an RTSP/HTTP URL, a video file). Each thread decodes every 4th frame
    and keeps the last good one; a source that ends keeps its last frame.
    Iterates (sources, (S, 3, H, W) letterboxed RGB, the S BGR frames,
    None), every frame letterboxed to one rectangle (``rect``) when the
    first frames all give the same one, else to the full square."""

    def __init__(self, sources='streams.txt', img_size=416):
        import cv2
        self.mode = 'images'
        self.img_size = img_size
        if str(sources).endswith('.txt') and os.path.isfile(sources):
            with open(sources) as f:
                sources = [x.strip() for x in f.read().splitlines()
                           if x.strip()]
        else:
            sources = [sources]
        self.sources = sources
        self.imgs = [None] * len(sources)
        self.threads = []
        for i, s in enumerate(sources):
            cap = cv2.VideoCapture(0 if s == '0' else s)
            if not cap.isOpened():
                raise FileNotFoundError(f'Failed to open {s}')
            ok, self.imgs[i] = cap.read()
            if not ok:
                raise RuntimeError(f'No frame from {s}')
            t = threading.Thread(target=self._update, args=(i, cap),
                                 daemon=True)
            t.start()
            self.threads.append(t)
        shapes = [letterbox(x, new_shape=self.img_size)[0].shape
                  for x in self.imgs]
        self.rect = len(set(shapes)) == 1

    def _update(self, i, cap):
        n = 0
        while cap.isOpened():
            n += 1
            if not cap.grab():
                break       # the end of a file, or a closed stream
            if n == 4:      # decode every 4th frame
                ok, frame = cap.retrieve()
                if ok:      # keep the last good frame on a dropout
                    self.imgs[i] = frame
                n = 0
            time.sleep(0.01)

    def __iter__(self):
        self.count = -1
        return self

    def __len__(self):
        return 0

    def __next__(self):
        self.count += 1
        img0 = [x.copy() for x in self.imgs]
        if _quit_pressed():
            _close_windows()
            raise StopIteration
        img = [letterbox(x, new_shape=self.img_size, auto=self.rect)[0]
               for x in img0]
        img = np.stack(img, 0)[:, :, :, ::-1].transpose(0, 3, 1, 2)
        return self.sources, np.ascontiguousarray(img), img0, None


class DetectionDataset:
    """Dataset over an image-list txt; labels are read from the sibling
    ``labels/`` txt of each image (``images`` -> ``labels``)."""

    def __init__(self, path, img_size=416, batch_size=16, augment=False,
                 hyp=None, rect=False, image_weights=False,
                 cache_images=False, is_gray_scale=False, subset_len=-1,
                 seed=None, process_shard=None, cutout=False,
                 ud_flip=False):
        path = str(Path(path))
        if not os.path.isfile(path):
            raise FileNotFoundError(f'File not found {path}')
        with open(path) as f:
            self.img_files = [x for x in f.read().splitlines()
                              if os.path.splitext(x)[-1].lower() in IMG_FORMATS]
        self.rnd = random.Random(seed)
        self._real = None       # the shard's pad mask (all real otherwise)
        if process_shard is not None:
            pi, pc = process_shard
            files = self.img_files[pi::pc]
            if not files:
                raise ValueError(f'process_shard {process_shard}: no files '
                                 f'of {len(self.img_files)}')
            n_pad = -(-len(self.img_files) // pc) - len(files)
            self._real = [True] * len(files) + [False] * n_pad
            self.img_files = files + [files[j % len(files)]
                                      for j in range(n_pad)]
        if subset_len != -1:
            if subset_len > len(self.img_files):
                raise ValueError(f'subset_len {subset_len} > '
                                 f'{len(self.img_files)} images')
            # indices, so that the pad mask stays aligned with the files
            keep = self.rnd.sample(range(len(self.img_files)), subset_len)
            self.img_files = [self.img_files[i] for i in keep]
            if self._real is not None:
                self._real = [self._real[i] for i in keep]
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
            if self._real is not None:
                self._real = [self._real[i] for i in order]
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
        """Image path for the batch metadata ('' for a shard's pad)."""
        if self._real is not None and not self._real[index]:
            return ''
        return self.img_files[index]

    def _read_shapes(self, path):
        """(w, h) of every image, from the ``.shapes`` sidecar of the list
        file when it is in sync, else read with PIL and written there. A
        shard's shapes are read directly: the sidecar is the whole list's,
        and another rank's shard may have the same length."""
        sharded = self._real is not None
        sp = path.replace('.txt', '.shapes')
        if not sharded:
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
        if not sharded:
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
    zero images, no labels and empty paths.

    ``use_native``: letterbox each batch in one pass of the host library
    (``_assemble_native``). None takes it under the JAX package's rule:
    the library builds, the dataset does not augment and is not gray. A
    failure there raises."""

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 max_targets: int = 0, shuffle: bool = False,
                 prefetch: int = 2, drop_last: bool = False, seed=None,
                 use_native: bool | None = None):
        self.ds = dataset
        self.bs = batch_size
        self.max_t = max_targets or (30 * batch_size)
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rnd = random.Random(seed)
        if use_native is None:
            from .. import native
            use_native = (not dataset.augment and not dataset.is_gray_scale
                          and native.available())
        self.use_native = use_native

    def __len__(self):
        if self.drop_last:
            return self.ds.n // self.bs
        return math.ceil(self.ds.n / self.bs)

    def _assemble_native(self, idxs):
        """The batch letterboxed by the host library in one pass; the
        label arithmetic is ``DetectionDataset.__getitem__``'s with the
        library's ratio and pads, as in the JAX package."""
        from ..native import letterbox_batch
        from ..train.loss import pad_targets
        ds = self.ds
        raw, metas = [], []
        for i in idxs:
            img, (h0, w0), (h, w) = ds._load_image(i)
            raw.append(img)
            metas.append((i, h0, w0, h, w))
        shape = (ds.batch_shapes[ds.batch[idxs[0]]] if ds.rect
                 else (ds.img_size, ds.img_size))
        dst_h, dst_w = int(shape[0]), int(shape[1])
        batch, ratios, pads = letterbox_batch(raw, dst_h, dst_w,
                                              scaleup=ds.augment)
        labels, paths, shapes = [], [], []
        for j, (i, h0, w0, h, w) in enumerate(metas):
            r = float(ratios[j])
            padw, padh = float(pads[j, 0]), float(pads[j, 1])
            lab = ds.labels[i]
            if lab.size:
                px = xywhn_to_xyxy_pixels(lab, w, h, padw, padh, r, r)
                out = px.copy()
                out[:, 1:5] = xyxy2xywh_np(px[:, 1:5])
                out[:, [2, 4]] /= dst_h
                out[:, [1, 3]] /= dst_w
                labels.append(out.astype(np.float32))
            else:
                labels.append(np.zeros((0, 5), np.float32))
            paths.append(ds.path_of(i))
            shapes.append(((h0, w0), ((h / h0, w / w0), (padw, padh))))
        while len(labels) < self.bs:
            batch = np.concatenate(
                [batch, np.zeros((1, dst_h, dst_w, batch.shape[3]), np.uint8)])
            labels.append(np.zeros((0, 5), np.float32))
            paths.append('')
            shapes.append(None)
        tgt, valid = pad_targets(labels, self.max_t)
        return batch, tgt, valid, paths, shapes

    def _assemble(self, idxs):
        from ..train.loss import pad_targets
        if self.use_native:
            return self._assemble_native(idxs)
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
