"""K1, NMS suppression: a CUDA kernel and its plain PyTorch twin.

``suppress`` is the counterpart of ``yolo_tpu/ops/pallas_nms.py::suppress``.
On a CUDA tensor it launches ``csrc/nms_suppress.cu`` (one thread-block
cluster per image, the suppression graph split by columns across the
cluster's shared memories, ``suppress_plan`` sizing the cluster); on a CPU
tensor it runs ``suppress_reference``, the batched form of
``yolo_tpu/ops/nms.py::_suppress_xla``. A CUDA tensor never falls back to
the plain version: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import load_library
from .boxes import box_iou_matrix

MAX_K = 1024          # candidates per image the kernel takes
WORD = 32             # candidates per bit word of the graph and of keep
THREADS = 512         # threads of a CTA (kThreads in the kernel)
CLUSTER_PORTABLE = 8  # the largest cluster every Hopper launch can take
CLUSTER_MAX = 16      # the largest, where the card holds enough of them
SMEM_LIMIT = 232448   # bytes of shared memory a CTA may take on an H100


class SuppressPlan(NamedTuple):
    cluster: int          # CTAs per image: one thread-block cluster
    ctas: int             # CTAs of the launch, bs * cluster
    runs: tuple           # (first, end) column of each CTA of an image
    smem: int             # bytes of dynamic shared memory per CTA


def words(k: int) -> int:
    """Bit words of a keep vector or of a graph column of k candidates."""
    return -(-k // WORD)


def smem_bytes(k: int, cluster: int) -> int:
    """Shared memory of a CTA, as ``smem_bytes`` in the kernel source
    counts it (a CPU test holds the two to each other): the class-offset
    boxes and their areas (padded to whole words), the raw boxes, score *
    valid, the graph of the CTA's longest run of columns, and the two keep
    buffers."""
    nw = words(k)
    return (20 * WORD * nw + 20 * k + 4 * WORD * nw * -(-nw // cluster)
            + 8 * nw)


@functools.lru_cache(maxsize=4096)
def suppress_plan(bs: int, k: int, wide: int = 0) -> SuppressPlan:
    """The cluster for ``bs`` images of ``k`` candidates.

    C = min(C_max, nw) CTAs per image, nw = ceil(k / 32): CTA r owns column
    words r * nw / C .. (r + 1) * nw / C - 1, runs of whole words that
    differ by at most one word. C_max is 16 where ``wide``, the clusters of
    min(16, nw) CTAs that the card holds at once at this k
    (``max_clusters``), is at least ``bs``; else 8, the portable size.
    Cached: the wrapper asks it on every call."""
    nw = words(k)
    c = min(CLUSTER_MAX if wide >= bs else CLUSTER_PORTABLE, nw)
    runs = tuple((WORD * (r * nw // c), WORD * ((r + 1) * nw // c))
                 for r in range(c))
    return SuppressPlan(c, bs * c, runs, smem_bytes(k, c))


def device_plan(bs: int, k: int, device: int) -> SuppressPlan:
    """The plan the wrapper launches on CUDA device ``device``:
    ``suppress_plan`` with the card's count of wide clusters, asked only
    where the plan could take more than the portable size."""
    nw = words(k)
    wide = (max_clusters(device, k, min(CLUSTER_MAX, nw))
            if nw > CLUSTER_PORTABLE else 0)
    return suppress_plan(bs, k, wide)


@functools.lru_cache(maxsize=None)
def max_clusters(device: int, k: int, cluster: int = CLUSTER_MAX) -> int:
    """How many clusters of ``cluster`` CTAs at this k the card ``device``
    holds at once (``cudaOccupancyMaxActiveClusters``); asked once."""
    lib = load_library()
    n = ctypes.c_int(0)
    err = lib.nms_suppress_max_clusters(k, cluster, device, ctypes.byref(n))
    if err != 0:
        raise RuntimeError('nms_suppress occupancy query failed: '
                           + lib.nms_suppress_error_string(err).decode())
    return n.value


def suppress_reference(oboxes, boxes, scores, valid, *, iou_thres: float,
                       max_sweeps: int = 16, merge: bool = True):
    """Greedy-NMS fixpoint plus merge-NMS in plain PyTorch.

    oboxes/boxes: (bs, k, 4) f32 class-offset / raw xyxy boxes; scores:
    (bs, k) f32; valid: (bs, k) bool. Returns (keep (bs, k) bool,
    merged (bs, k, 4) f32). Runs exactly ``max_sweeps`` sweeps of
    ``keep = valid & !any_i(tri[i, j] & keep[i])``; past the fixpoint a
    sweep changes nothing."""
    k = oboxes.shape[1]
    thres = torch.tensor(iou_thres, dtype=torch.float32)
    over = box_iou_matrix(oboxes, oboxes) > thres            # (bs, k, k)
    ar = torch.arange(k, device=oboxes.device)
    tri = over & (ar[:, None] < ar[None, :])
    keep = valid
    for _ in range(max_sweeps):
        keep = valid & ~(tri & keep[:, :, None]).any(1)
    if not merge:
        return keep, boxes
    w = over.to(torch.float32) * (scores * valid)[:, None, :]
    denom = w.sum(-1, keepdim=True)
    fused = (w @ boxes) / denom.clamp_min(1e-12)
    return keep, torch.where(denom > 0, fused, boxes)


def _check(oboxes, boxes, scores, valid):
    bs, k = valid.shape
    for name, t, shape, dtype in (('oboxes', oboxes, (bs, k, 4), torch.float32),
                                  ('boxes', boxes, (bs, k, 4), torch.float32),
                                  ('scores', scores, (bs, k), torch.float32),
                                  ('valid', valid, (bs, k), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f'suppress: {name} must be {dtype} of shape '
                             f'{shape}, got {t.dtype} {tuple(t.shape)}')
        if t.device != valid.device:
            raise ValueError(f'suppress: {name} is on {t.device}, '
                             f'valid on {valid.device}')
        if not t.is_contiguous():
            raise ValueError(f'suppress: {name} must be contiguous')
    if k > MAX_K:
        raise ValueError(f'suppress: k={k} exceeds the kernel limit {MAX_K}')


def suppress(oboxes, boxes, scores, valid, *, iou_thres: float,
             max_sweeps: int = 16, merge: bool = True):
    """Batched suppression + merge (contract of ``suppress_reference``).

    ``scores`` are the candidate scores times ``valid``; invalid rows of the
    boxes must already be zero (``nms._suppress_and_finalize`` does both).
    Each kernel launch adds one to ``suppress.launches``."""
    if valid.device.type == 'cpu':
        return suppress_reference(oboxes, boxes, scores, valid,
                                  iou_thres=iou_thres, max_sweeps=max_sweeps,
                                  merge=merge)
    if valid.device.type != 'cuda':
        raise ValueError(f'suppress: no kernel for device {valid.device}')
    _check(oboxes, boxes, scores, valid)
    bs, k = valid.shape
    keep = torch.empty((bs, k), dtype=torch.bool, device=valid.device)
    merged = torch.empty((bs, k, 4), dtype=torch.float32, device=valid.device)
    if bs == 0 or k == 0:
        return keep, merged
    plan = device_plan(bs, k, valid.device.index)
    _launch(oboxes, boxes, scores, valid, keep, merged, iou_thres, max_sweeps,
            merge, plan.cluster)
    return keep, merged


def _launch(oboxes, boxes, scores, valid, keep, merged, iou_thres, max_sweeps,
            merge, cluster):
    """One launch of the kernel with ``cluster`` CTAs per image on checked
    CUDA tensors, into ``keep`` and ``merged``; adds one to
    ``suppress.launches``, or raises if the launch is refused."""
    lib = load_library()
    # the kernel reads the boxes in 16-byte pieces
    oboxes, boxes = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (oboxes, boxes))
    bs, k = valid.shape
    dev = valid.device.index
    err = lib.nms_suppress_launch(
        oboxes.data_ptr(), boxes.data_ptr(), scores.data_ptr(),
        valid.data_ptr(), keep.data_ptr(), merged.data_ptr(), bs, k,
        float(iou_thres), int(max_sweeps), int(bool(merge)), cluster, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError('nms_suppress kernel launch failed: '
                           + lib.nms_suppress_error_string(err).decode())
    suppress.launches += 1


suppress.launches = 0
