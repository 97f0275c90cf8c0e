"""The legacy quantizer family (counterpart of
``yolo_tpu/compress/quant_legacy.py``): DoReFa, plain min/max PTQ and the
1-bit / ternary weight transforms, as functions on tensors.

They are the weight and activation transforms of the 'dorefa', 'wbin' and
'ternary' schemes of ``compress/quant.py``. Every one is a straight-through
estimator written ``x + (t - x).detach()``: the forward value is the
quantized ``t`` (as the JAX package computes it), the gradient the identity.
The clip of ``dorefa_activation`` is a ``minimum``/``maximum`` pair against
tensor bounds, whose gradient at either edge is 0.5, as JAX's ``clip``
gives (``torch.clamp`` gives 1 there).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_reduce_max, all_reduce_nograd
from .quant import _clip, fq, pow2_snap, round_half_away


def _ste(x, t):
    """``t`` in the forward, the identity in the backward."""
    return x + (t - x).detach()


def quantize_k(x, k: int):
    """Uniform k-bit quantization of x in [0, 1] (DoReFa quantize_k)."""
    n = float((1 << k) - 1)
    y = x * n
    return _ste(y, torch.round(y)) / n


def dorefa_weight(w, bits: int, group=None):
    """DoReFa-Net weights: tanh-normalise to [0, 1], k-bit quantize, map
    back to [-1, 1]. 1-bit weights are refused (the 'wbin' scheme is the
    1-bit one). ``group``: ``w`` is this rank's block of a tensor split
    over it (tensor parallelism), and ``max|tanh w|``, which carries a
    gradient, is the whole tensor's (``all_reduce_max``)."""
    if bits == 32:
        return w
    if bits == 1:
        raise ValueError("DoReFa 1-bit weights are unsupported; use the "
                         "'wbin' scheme instead")
    t = torch.tanh(w)
    t = t / (2.0 * all_reduce_max(torch.abs(t), group) + 1e-12) + 0.5
    return 2.0 * quantize_k(t, bits) - 1.0


def dorefa_activation(x, bits: int):
    """DoReFa activations: pre-scale by 0.1, clip to [0, 1], k-bit
    quantize. The 0.1 is never undone: the quantized activation is 0.1x the
    float one, as in the reference. 1-bit activations are refused."""
    if bits == 32:
        return x
    if bits == 1:
        raise ValueError('DoReFa 1-bit activations are unsupported')
    return quantize_k(_clip(x * 0.1, 0.0, 1.0), bits)


def binary_weight(w):
    """sign(w), with a straight-through gradient."""
    return _ste(w, torch.sign(w))


def bwn_weight(w):
    """Binary-Weight-Network: sign(w) * mean(|w|) per tensor."""
    alpha = torch.mean(torch.abs(w))
    return _ste(w, torch.sign(w) * alpha)


def ternary_weight(w, thresh_factor: float = 0.7, group=None):
    """Ternarize to {-a, 0, +a} with delta = factor * mean|w| and a the mean
    |w| of the entries beyond delta. ``group``: ``w`` is this rank's block
    of a tensor split over it, and both means are the whole tensor's, each
    a sum and a count summed over the ranks (no gradient: the result is a
    straight-through estimator)."""
    if group is None:
        delta = thresh_factor * torch.mean(torch.abs(w))
    else:
        s = all_reduce_nograd(torch.stack(
            [torch.sum(torch.abs(w)), w.new_tensor(w.numel())]), group)
        delta = thresh_factor * (s[0] / s[1])
    mask_pos = w > delta
    mask_neg = w < -delta
    nz = mask_pos | mask_neg
    mass = torch.stack([torch.sum(torch.abs(w) * nz),
                        torch.sum(nz).to(w.dtype)])
    if group is not None:
        mass = all_reduce_nograd(mass, group)
    alpha = mass[0] / torch.clamp_min(mass[1], 1)
    t = alpha * (mask_pos.to(w.dtype) - mask_neg.to(w.dtype))
    return _ste(w, t)


def minmax_ptq_scale(x, bits: int, sym: bool = True, pow2: bool = False):
    """Plain min/max calibration: (scale, zero point) from the observed
    range, with an optional pow-2 snap of the range."""
    qmax = (1 << (bits - 1)) - 1 if sym else (1 << bits) - 1
    if sym:
        r = torch.maximum(torch.abs(torch.min(x)), torch.abs(torch.max(x)))
        r = pow2_snap(r) if pow2 else r
        return r / qmax, torch.zeros((), dtype=r.dtype, device=r.device)
    r = torch.max(x) - torch.min(x)
    r = pow2_snap(r) if pow2 else r
    scale = r / qmax
    return scale, round_half_away(qmax - torch.max(x) / scale)


def minmax_ptq(x, bits: int, sym: bool = True, pow2: bool = False):
    scale, zp = minmax_ptq_scale(x.detach(), bits, sym, pow2)
    return fq(x, scale, zp, bits, sym)
