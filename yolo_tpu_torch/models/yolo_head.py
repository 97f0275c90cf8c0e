"""YOLO head decode (counterpart of yolo_tpu/models/yolo_head.py).

Head maps are NHWC ``(bs, ny, nx, na*no)``: the ``permute(0, 2, 3, 1)`` view
of a channels_last conv output, channels anchor-major.
"""

from __future__ import annotations

import torch


def reshape_pred(x, na: int, no: int):
    """NHWC head map (bs, ny, nx, na*no) -> raw prediction (bs, na, ny, nx, no)."""
    bs, ny, nx, _ = x.shape
    return x.reshape(bs, ny, nx, na, no).permute(0, 3, 1, 2, 4)


def _grid(ny, nx, device):
    gy, gx = torch.meshgrid(torch.arange(ny, dtype=torch.float32, device=device),
                            torch.arange(nx, dtype=torch.float32, device=device),
                            indexing='ij')
    return torch.stack([gx, gy], -1)                                 # (ny, nx, 2)


def decode_yolo(p, anchors, stride: int):
    """Raw predictions (bs, na, ny, nx, no) -> io (bs, na*ny*nx, no): xywh in
    pixels, sigmoid objectness and class scores (anchor-major order)."""
    bs, na, ny, nx, no = p.shape
    anchor_vec = torch.as_tensor(anchors, dtype=p.dtype, device=p.device) / stride
    grid = _grid(ny, nx, p.device).to(p.dtype)[None, None]
    xy = (torch.sigmoid(p[..., 0:2]) + grid) * stride
    wh = torch.exp(p[..., 2:4]) * anchor_vec[None, :, None, None, :] * stride
    io = torch.cat([xy, wh, torch.sigmoid(p[..., 4:])], -1)
    return io.reshape(bs, -1, no)


def anchors_on(yolos, cache: dict, device) -> list[torch.Tensor]:
    """Per-scale (na, 2) f32 pixel anchors of the ``yolos`` layers on
    ``device``, copied there once and kept in ``cache``: a host-to-device
    copy on every call would synchronise the stream."""
    anc = cache.get(device)
    if anc is None:
        anc = cache[device] = [torch.as_tensor(l.anchors, dtype=torch.float32,
                                               device=device) for l in yolos]
    return anc


def decode_yolo_nhwc(x, anchors, stride: int, no: int):
    """Decode straight from the NHWC head map (bs, ny, nx, na*no) in f32.
    Returns io (bs, ny*nx*na, no) in row-major (y, x, a) order."""
    bs, ny, nx, ch = x.shape
    na = ch // no
    p = x.to(torch.float32).reshape(bs, ny, nx, na, no)
    anc = torch.as_tensor(anchors, dtype=torch.float32, device=x.device)
    grid = _grid(ny, nx, x.device)[None, :, :, None]                 # (1,ny,nx,1,2)
    xy = (torch.sigmoid(p[..., 0:2]) + grid) * stride
    wh = torch.exp(p[..., 2:4]) * anc
    io = torch.cat([xy, wh, torch.sigmoid(p[..., 4:])], -1)
    return io.reshape(bs, -1, no)
