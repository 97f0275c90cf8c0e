"""K4, the depthwise int8 conv: a CUDA kernel and its plain PyTorch twin.

``fused_depthwise_int8`` runs one int8 conv in which each output channel
reads its own input channel (``groups == Cin == Cout``; MobileNet's 3x3 and
5x5 depthwise convs) and K2's f32 epilogue:

    acc = sum over (ky, kx) of x8[n, oy*sy + ky - py, ox*sx + kx - px, c]
                               * w8[c, ky, kx, 0]      (exact)
    y   = act(f32(acc) * scale + bias)                 (f32, no fused
                                                        multiply-add)
    out = int8(clip(round_half_away(y * oinv), qmin, qmax))

with x8 int8 NHWC, w8 int8 (C, K, K, 1) as the int8 engine's plan stores
it, K odd up to 7, ``stride`` and ``pad`` an int or a (y, x) pair (the
spatially split engine passes ``(0, pad)`` on a block of rows with its
halo), strides 1 or 2, and ``oinv`` as ``int8_math.out_multiplier`` forms
it (TPSQ passes its ``out_mult``).

On a CUDA tensor it launches ``csrc/depthwise_int8.cu`` (one launch a conv:
a thread sums a run of four outputs of a row for 8 channels, each input
column loaded once and turned into exact f32 sums in registers, the
block's weights in shared memory, the epilogue fused; nothing is padded,
cast or transposed in PyTorch) or raises; on a CPU tensor it runs
``fused_depthwise_int8_reference``, the plain path the engine ran before
(``int8_math.grouped_conv_s32`` and K2's epilogue). There is no fallback
from CUDA to the plain version. ``conv_int8.grouped_conv_int8`` sends a
conv here where ``takes`` holds and the tensors are on the card.

The JAX package has no kernel for this conv: it leaves it to XLA's s8 conv.
"""

from __future__ import annotations

import torch

from .._build import check_tensors, kernel, on_card
from .int8_math import (ACT_CODES, epilogue, f32, grouped_conv_s32,
                        out_multiplier)

WINDOWS = (1, 3, 5, 7)      # the kernel's K (csrc/depthwise_int8.cu)
STRIDES = (1, 2)

_k4 = kernel('depthwise_int8', 'pppp iiiiiiiiiii ffif ii', 'k4.launches')


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def takes(x8, w8, groups: int, stride, pad) -> bool:
    """Whether K4 takes the conv: depthwise (``w8`` (C, K, K, 1), ``groups``
    == C == x8's channels), a square window of ``WINDOWS``, both strides in
    ``STRIDES``, no negative padding."""
    if w8.dim() != 4:
        return False
    c, kh, kw, cg = w8.shape
    if cg != 1 or groups != c or x8.shape[-1] != c or kh != kw:
        return False
    (sy, sx), (py, px) = _pair(stride), _pair(pad)
    return (kh in WINDOWS and sy in STRIDES and sx in STRIDES and py >= 0
            and px >= 0)


def out_size(h: int, w: int, k: int, stride, pad) -> tuple[int, int]:
    """(Ho, Wo) of a K x K conv of an H x W input."""
    (sy, sx), (py, px) = _pair(stride), _pair(pad)
    return (h + 2 * py - k) // sy + 1, (w + 2 * px - k) // sx + 1


def fused_depthwise_int8_reference(x8, w8, bias, scale, out_scale, *, stride,
                                   pad, act: str = 'leaky',
                                   maxabs: bool = False, qmin: int = -128,
                                   qmax: int = 127, out_mult=None):
    """Plain PyTorch version of ``fused_depthwise_int8`` (same contract): the
    exact int32 sums tap by tap, then K2's f32 epilogue, as separate
    PyTorch operations on any device."""
    acc = grouped_conv_s32(x8, w8, stride=stride, pad=pad,
                           groups=x8.shape[-1])
    return epilogue(acc, bias, scale, out_scale, act, maxabs, True, qmin,
                    qmax, out_mult)


def _check(x8, w8, bias, stride, pad, act, qmin, qmax):
    """Raise on what the kernel does not take; returns (Ho, Wo)."""
    if x8.dim() != 4 or w8.dim() != 4 or bias.dim() != 1:
        raise ValueError('fused_depthwise_int8: x8 must be (N, H, W, C), w8 '
                         '(C, K, K, 1) and bias (C,)')
    check_tensors('fused_depthwise_int8', (('x8', x8, torch.int8),
                                           ('w8', w8, torch.int8),
                                           ('bias', bias, torch.float32)))
    n, h, w, c = x8.shape
    k = w8.shape[1]
    if (w8.shape[0] != c or w8.shape[2] != k or w8.shape[3] != 1
            or bias.shape[0] != c):
        raise ValueError(f'fused_depthwise_int8: widths do not match: x8 '
                         f'{tuple(x8.shape)}, w8 {tuple(w8.shape)}, bias '
                         f'{tuple(bias.shape)}')
    if not takes(x8, w8, c, stride, pad):
        raise ValueError(f'fused_depthwise_int8: unsupported conv k={k} '
                         f'stride={stride} pad={pad}')
    ho, wo = out_size(h, w, k, stride, pad)
    if ho < 1 or wo < 1:
        raise ValueError(f'fused_depthwise_int8: a {k}x{k} window does not '
                         f'fit x8 {tuple(x8.shape)} padded by {pad}')
    if act not in ACT_CODES:
        raise ValueError(f'fused_depthwise_int8: unsupported activation '
                         f'{act!r}')
    if not -128 <= qmin <= qmax <= 127:
        raise ValueError(f'fused_depthwise_int8: [{qmin}, {qmax}] is not an '
                         'int8 range')
    return ho, wo


def fused_depthwise_int8(x8, w8, bias, scale, out_scale, *, stride, pad,
                         act: str = 'leaky', maxabs: bool = False,
                         qmin: int = -128, qmax: int = 127, out_mult=None):
    """Depthwise int8 conv: int8 NHWC x int8 (C, K, K, 1) -> int8 NHWC (see
    the module docstring). The inputs are checked on every device; a CPU
    tensor then runs the plain version, a CUDA tensor launches the kernel
    (each launch adds one to the counter ``k4.launches``) or raises."""
    card = on_card('fused_depthwise_int8', x8)
    ho, wo = _check(x8, w8, bias, stride, pad, act, qmin, qmax)
    if not card:
        return fused_depthwise_int8_reference(
            x8, w8, bias, scale, out_scale, stride=stride, pad=pad, act=act,
            maxabs=maxabs, qmin=qmin, qmax=qmax, out_mult=out_mult)
    n, h, w, c = x8.shape
    k = w8.shape[1]
    (sy, sx), (py, px) = _pair(stride), _pair(pad)
    out = torch.empty((n, ho, wo, c), dtype=torch.int8, device=x8.device)
    if out.numel() == 0:
        return out
    _k4(x8.device.index, x8.data_ptr(), w8.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, w, c, k, sy, sx, py, px, ho, wo,
        float(f32(scale)), float(out_multiplier(out_scale, out_mult)),
        ACT_CODES[act], 0.25 if maxabs else 0.1, int(qmin), int(qmax))
    return out
