"""K3, the fused int8 shortcut: a CUDA kernel and its plain PyTorch twin.

``fused_shortcut_int8`` runs one requantized shortcut of the int8 engine
(``models/int8_engine.py`` ``shortcut_i8``: one ``from`` layer, no fusion
weights, both edges int8) in one pass:

    x  = f32(x8) * sx,  a = f32(a8) * sa
    xq = rha(x * (1 / in_scale)) * in_scale     (the same for aq; way 2
                                                 clamps rha(...) to
                                                 [qmin, qmax] first)
    s  = xq + aq       (nx > na: the channels past na carry xq alone;
                        nx < na: a is cut to nx channels)
    x' = clamp(rha(s * (1 / sc)), qmin, qmax) * sc
    q  = int8(clamp(rha(x' * (1 / sc)), qmin, qmax))

with ``rha`` round half away from zero, x8 (N, H, W, nx) and a8 (N, H, W,
na) int8 NHWC, q (N, H, W, nx), and every scale a Python float that the f32
operations round once to f32, as PyTorch rounds a scalar operand.

On a CUDA tensor it launches ``csrc/shortcut_int8.cu`` (one grid-stride
streaming pass: each block first runs the chain's steps for every int8 code
into tables in shared memory, then an element costs two table reads, the
add and the rounding of the sum, and a byte read of its code) or raises; on
a CPU tensor it runs ``fused_shortcut_int8_reference``. There is no
fallback from CUDA to the plain version.
"""

from __future__ import annotations

import torch

from .._build import check_tensors, kernel, on_card
from .int8_math import round_half_away

_k3 = kernel('shortcut_int8', 'pppqii ffffff iii', 'k3.launches')


def shortcut_requant(x, a, in_scale, sc, *, way: int, qmin: int, qmax: int):
    """One step of the sim's shortcut chain on f32 edges ``x`` and ``a``:
    each fake-quantized to ``in_scale`` (way 2, the max way, saturating;
    way 1, the min way, unclamped), summed by darknet's channel rule, the
    sum fake-quantized to ``sc``. Returns f32 of ``x``'s shape."""
    inv_in, inv_sc = 1.0 / in_scale, 1.0 / sc
    if way == 2:
        xq = torch.clamp(round_half_away(x * inv_in), qmin, qmax) * in_scale
        aq = torch.clamp(round_half_away(a * inv_in), qmin, qmax) * in_scale
    else:
        xq = round_half_away(x * inv_in) * in_scale
        aq = round_half_away(a * inv_in) * in_scale
    nx, na = xq.shape[-1], aq.shape[-1]
    if nx == na:
        s = xq + aq
    elif nx > na:
        s = torch.cat([xq[..., :na] + aq, xq[..., na:]], -1)
    else:
        s = xq + aq[..., :nx]
    return torch.clamp(round_half_away(s * inv_sc), qmin, qmax) * sc


def shortcut_codes(x, sc, *, qmin: int, qmax: int):
    """The int8 codes of the chain's f32 result ``x`` on the grid ``sc``."""
    q = torch.clamp(round_half_away(x * (1.0 / sc)), qmin, qmax)
    return q.to(torch.int8)


def fused_shortcut_int8_reference(x8, sx, a8, sa, in_scale, sc, *, way: int,
                                  qmin: int, qmax: int):
    """Plain PyTorch version of ``fused_shortcut_int8`` (same contract): the
    engine's f32 chain, operation for operation."""
    x = shortcut_requant(x8.to(torch.float32) * sx,
                         a8.to(torch.float32) * sa, in_scale, sc, way=way,
                         qmin=qmin, qmax=qmax)
    return shortcut_codes(x, sc, qmin=qmin, qmax=qmax)


def _check(x8, a8, way, qmin, qmax):
    for name, t in (('x8', x8), ('a8', a8)):
        if t.dim() != 4:
            raise ValueError(f'fused_shortcut_int8: {name} must be (N, H, W, '
                             f'C), got {tuple(t.shape)}')
    check_tensors('fused_shortcut_int8', (('x8', x8, torch.int8),
                                          ('a8', a8, torch.int8)))
    if x8.shape[:3] != a8.shape[:3] or a8.shape[3] == 0:
        raise ValueError(f'fused_shortcut_int8: shapes do not match: x8 '
                         f'{tuple(x8.shape)}, a8 {tuple(a8.shape)}')
    if way not in (1, 2):
        raise ValueError(f'fused_shortcut_int8: way {way} is not 1 or 2')
    if not -128 <= qmin <= qmax <= 127:
        raise ValueError(f'fused_shortcut_int8: [{qmin}, {qmax}] is not an '
                         'int8 range')


def fused_shortcut_int8(x8, sx, a8, sa, in_scale, sc, *, way: int, qmin: int,
                        qmax: int):
    """One requantized int8 shortcut: int8 NHWC ``x8`` (scale ``sx``) and
    ``a8`` (scale ``sa``) -> int8 NHWC codes of scale ``sc`` (see the module
    docstring; ``in_scale`` is the shortcut's input scale).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (each launch adds one to the counter ``k3.launches``) or raises."""
    if not on_card('fused_shortcut_int8', x8):
        return fused_shortcut_int8_reference(x8, sx, a8, sa, in_scale, sc,
                                             way=way, qmin=qmin, qmax=qmax)
    _check(x8, a8, way, qmin, qmax)
    out = torch.empty(x8.shape, dtype=torch.int8, device=x8.device)
    if out.numel() == 0:
        return out
    n, h, w, nx = x8.shape
    # ctypes rounds each scale to f32, to nearest, as PyTorch rounds a
    # Python float operand of an f32 tensor
    _k3(x8.device.index, x8.data_ptr(), a8.data_ptr(), out.data_ptr(),
        n * h * w, nx, a8.shape[3], sx, sa, 1.0 / in_scale, in_scale,
        1.0 / sc, sc, way, int(qmin), int(qmax))
    return out
