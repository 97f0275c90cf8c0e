"""Inference image/video source of the detection CLI (the port's copy of
``LoadImages`` and ``_read_image`` from ``yolo_tpu/data/datasets.py``).
OpenCV is imported inside the functions only."""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from .transforms import letterbox

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
