"""NMS suppression stage: a CUDA kernel and its plain PyTorch twin.

``suppress`` is the counterpart of ``yolo_tpu/ops/pallas_nms.py::suppress``.
On a CUDA tensor it launches ``csrc/nms_suppress.cu`` (one thread block per
image, the suppression graph as a bitmask in shared memory); on a CPU tensor
it runs ``suppress_reference``, the batched form of
``yolo_tpu/ops/nms.py::_suppress_xla``. A CUDA tensor never falls back to
the plain version: the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

from .boxes import box_iou_matrix

MAX_K = 1024   # one thread per candidate, one block per image


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
    from .._build import load_library
    lib = load_library()
    with torch.cuda.device(valid.device):
        stream = torch.cuda.current_stream(valid.device).cuda_stream
        err = lib.nms_suppress_launch(
            oboxes.data_ptr(), boxes.data_ptr(), scores.data_ptr(),
            valid.data_ptr(), keep.data_ptr(), merged.data_ptr(), bs, k,
            float(iou_thres), int(max_sweeps), int(bool(merge)), stream)
    if err != 0:
        raise RuntimeError('nms_suppress kernel launch failed: '
                           + lib.nms_suppress_error_string(err).decode())
    suppress.launches += 1
    return keep, merged


suppress.launches = 0
