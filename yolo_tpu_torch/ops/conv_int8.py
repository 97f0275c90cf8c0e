"""K2, the fused int8 conv: a CUDA kernel and its plain PyTorch twin.

``fused_conv_int8`` is the counterpart of
``yolo_tpu/ops/pallas_conv.py::fused_conv_int8``:

    acc = conv_s32(x8, w8)                    (s8 x s8, exact s32 sums)
    y   = act(f32(acc) * scale + bias)        (f32, no multiply-add fusion)
    out = clip(round_half_away(y * (1 / out_scale)), qmin, qmax) -> int8
          (``out_q``), else y in f32

with x8 int8 NHWC, w8 int8 (Cout, K, K, Cin) (OHWI: Cin innermost, the
order the kernel reads), bias f32[Cout], ``scale`` and ``out_scale``
per-tensor f32 scalars, pad K // 2, groups 1.

On a CUDA tensor it launches ``csrc/conv_int8.cu`` (an implicit GEMM on
``__dp4a``, one thread block per 128 output pixels x 64 output channels)
or raises; on a CPU tensor it runs ``fused_conv_int8_reference``. There is
no fallback from CUDA to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import activations as act_mod

# activation codes of csrc/conv_int8.cu
ACT_CODES = {'linear': 0, 'none': 0, '': 0, 'leaky': 1, 'relu': 2,
             'relu6': 3, 'mish': 4, 'swish': 5, 'logistic': 6, 'h_swish': 7,
             'h_sigmoid': 8}


def supported(k: int, stride: int, pad: int, groups: int) -> bool:
    """The convs K2 takes: 1x1 stride 1 and 3x3 stride 1 or 2, 'same'
    padding, ungrouped (the truth table of the JAX package's kernel)."""
    return (groups == 1 and pad == k // 2
            and ((k == 1 and stride == 1) or (k == 3 and stride in (1, 2))))


def _f32(v) -> np.float32:
    return np.float32(v.item() if torch.is_tensor(v) else v)


def round_half_away(x):
    """sign(x) * floor(|x| + 0.5): ties go away from zero (``torch.round``
    rounds them to even and is wrong here)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def fused_conv_int8_reference(x8, w8, bias, scale, out_scale, *, stride: int,
                              act: str = 'leaky', maxabs: bool = False,
                              out_q: bool = True, qmin: int = -128,
                              qmax: int = 127):
    """Plain PyTorch version of ``fused_conv_int8`` (same contract).

    The conv runs in float64 on the int8 values: every product and partial
    sum is an integer below 2^53, so it is exact in any order, and equals
    the s32 accumulator. The epilogue repeats the kernel's f32 operations
    in the same order."""
    k = w8.shape[1]
    acc = F.conv2d(x8.permute(0, 3, 1, 2).to(torch.float64),
                   w8.permute(0, 3, 1, 2).to(torch.float64),
                   stride=stride, padding=k // 2)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32).to(torch.float32)
    dev = x8.device
    s = torch.tensor(_f32(scale), device=dev)
    y = acc * s + bias.to(torch.float32)
    y = act_mod.get(act, maxabs)(y)
    if not out_q:
        return y.contiguous()
    oinv = torch.tensor(np.float32(1.0) / _f32(out_scale), device=dev)
    q = torch.clamp(round_half_away(y * oinv), qmin, qmax)
    return q.to(torch.int8).contiguous()


def _check(x8, w8, bias, stride, act, qmin, qmax):
    if x8.dim() != 4 or w8.dim() != 4 or bias.dim() != 1:
        raise ValueError('fused_conv_int8: x8 must be (N, H, W, Cin), w8 '
                         '(Cout, K, K, Cin) and bias (Cout,)')
    n, h, w, cin = x8.shape
    cout, k, k2, wcin = w8.shape
    for name, t, dtype in (('x8', x8, torch.int8), ('w8', w8, torch.int8),
                           ('bias', bias, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f'fused_conv_int8: {name} must be {dtype}, '
                             f'got {t.dtype}')
        if t.device != x8.device:
            raise ValueError(f'fused_conv_int8: {name} is on {t.device}, '
                             f'x8 on {x8.device}')
        if not t.is_contiguous():
            raise ValueError(f'fused_conv_int8: {name} must be contiguous')
        if t.data_ptr() % 4:
            raise ValueError(f'fused_conv_int8: {name} must be 4-byte '
                             'aligned')
    if k != k2 or wcin != cin or bias.shape[0] != cout:
        raise ValueError(f'fused_conv_int8: shapes do not match: x8 '
                         f'{tuple(x8.shape)}, w8 {tuple(w8.shape)}, bias '
                         f'{tuple(bias.shape)}')
    if not supported(k, stride, k // 2, 1):
        raise ValueError(f'fused_conv_int8: unsupported conv k={k} '
                         f's={stride}')
    if act not in ACT_CODES:
        raise ValueError(f'fused_conv_int8: unsupported activation {act!r}')
    if not -128 <= qmin <= qmax <= 127:
        raise ValueError(f'fused_conv_int8: [{qmin}, {qmax}] is not an int8 '
                         'range')


def fused_conv_int8(x8, w8, bias, scale, out_scale, *, stride: int,
                    act: str = 'leaky', maxabs: bool = False,
                    out_q: bool = True, qmin: int = -128, qmax: int = 127):
    """Quantized conv: int8 NHWC x int8 (Cout, K, K, Cin) -> int8 NHWC
    (``out_q``) or f32 NHWC. ``qmin``/``qmax`` bound the output grid.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (each launch adds one to ``fused_conv_int8.launches``) or raises."""
    if x8.device.type == 'cpu':
        return fused_conv_int8_reference(x8, w8, bias, scale, out_scale,
                                         stride=stride, act=act, maxabs=maxabs,
                                         out_q=out_q, qmin=qmin, qmax=qmax)
    if x8.device.type != 'cuda':
        raise ValueError(f'fused_conv_int8: no kernel for device {x8.device}')
    _check(x8, w8, bias, stride, act, qmin, qmax)
    n, h, w, cin = x8.shape
    cout, k = w8.shape[0], w8.shape[1]
    if cin % 4:
        # the kernel reads 4 channels per 32-bit word: zero-pad Cin (a copy,
        # only for such odd widths; zeros add nothing to the sums)
        x8 = F.pad(x8, (0, -cin % 4))
        w8 = F.pad(w8, (0, -cin % 4))
        cin = x8.shape[-1]
    pad = k // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    out = torch.empty((n, ho, wo, cout),
                      dtype=torch.int8 if out_q else torch.float32,
                      device=x8.device)
    if out.numel() == 0:
        return out
    from .._build import load_library
    lib = load_library()
    slope = 0.25 if maxabs else 0.1
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream(x8.device).cuda_stream
        err = lib.conv_int8_launch(
            x8.data_ptr(), w8.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, h, w, cin, cout, k, stride, pad, ho, wo,
            float(_f32(scale)), float(np.float32(1.0) / _f32(out_scale)),
            ACT_CODES[act], slope, int(bool(out_q)), int(qmin), int(qmax),
            stream)
    if err != 0:
        raise RuntimeError('conv_int8 kernel launch failed: '
                           + lib.conv_int8_error_string(err).decode())
    fused_conv_int8.launches += 1
    return out


fused_conv_int8.launches = 0
