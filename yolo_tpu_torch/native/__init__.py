"""The host library of the data path (the port's copy of
``yolo_tpu/native``): ``csrc/fastpre.cpp``, C++ with OpenMP, built with g++
by ``_build.build_host`` at first use and loaded with ctypes.

- ``letterbox_batch``: a whole batch letterboxed into one NHWC uint8
  buffer (bilinear, grey pad, BGR -> RGB), one image a thread;
- ``normalize_batch``: uint8 -> f32 (/256, or (-1, 1) under maxabs) on
  host threads.

``available()`` says whether the library built and loaded; when it did
not, ``build_log()`` holds g++'s output. The batch loader takes this path
only when it is available (``data/datasets.py`` ``BatchLoader``); a call
here without the library raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .. import _build


@functools.cache
def _load():
    """The loaded library, or None when it does not build or load."""
    try:
        lib = ctypes.CDLL(str(_build.build_host()))
    except (OSError, RuntimeError):
        return None
    lib.letterbox_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.float32),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.letterbox_batch.restype = None
    lib.normalize_batch.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
        np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS'),
        ctypes.c_int64, ctypes.c_int32,
    ]
    lib.normalize_batch.restype = None
    lib.fastpre_num_threads.argtypes = []
    lib.fastpre_num_threads.restype = ctypes.c_int32
    return lib


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError('the native fastpre library did not build:\n'
                           + build_log())
    return lib


def available() -> bool:
    return _load() is not None


def build_log() -> str:
    """g++'s output for the current source and flags."""
    return _build.host_build_log()


def num_threads() -> int:
    """OpenMP's thread count in the library; 0 without the library."""
    lib = _load()
    return int(lib.fastpre_num_threads()) if lib else 0


def letterbox_batch(images: list[np.ndarray], dst_h: int, dst_w: int,
                    pad_value: int = 114, scaleup: bool = True,
                    bgr2rgb: bool = True):
    """List of HWC uint8 images (BGR) -> ((n, dst_h, dst_w, c) RGB uint8,
    ratios (n,) f32, pads (n, 2) f32: the halves dw, dh)."""
    lib = _lib()
    n = len(images)
    if n == 0:
        raise ValueError('letterbox_batch of no images')
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    c = images[0].shape[2]
    if any(im.ndim != 3 or im.shape[2] != c for im in images):
        raise ValueError('letterbox_batch needs HWC images of one channel '
                         f'count: {[im.shape for im in images]}')
    src_ptrs = (ctypes.c_void_p * n)(*[im.ctypes.data for im in images])
    src_h = np.array([im.shape[0] for im in images], np.int32)
    src_w = np.array([im.shape[1] for im in images], np.int32)
    dst = np.empty((n, dst_h, dst_w, c), np.uint8)
    ratios = np.empty(n, np.float32)
    pads = np.empty((n, 2), np.float32)
    lib.letterbox_batch(src_ptrs, src_h, src_w, n, c, dst, dst_h, dst_w,
                        ratios, pads, pad_value, int(scaleup), int(bgr2rgb))
    return dst, ratios, pads


def normalize_batch(batch_u8: np.ndarray, maxabs: bool = False) -> np.ndarray:
    """uint8 array -> f32 of the same shape: x / 256, or x / 128 - 1 under
    ``maxabs``."""
    lib = _lib()
    batch_u8 = np.ascontiguousarray(batch_u8, np.uint8)
    out = np.empty(batch_u8.shape, np.float32)
    lib.normalize_batch(batch_u8.reshape(-1), out.reshape(-1),
                        batch_u8.size, int(maxabs))
    return out
