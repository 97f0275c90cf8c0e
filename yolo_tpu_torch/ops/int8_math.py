"""The plain int8 arithmetic that the kernels' twins, the fake-quant sim and
the int8 engine share: rounding, the f32 scalars and multiplier of a
requant, the activation codes of the kernels, K2's f32 epilogue and the
exact s32 sums of any int8 conv.

It imports no kernel wrapper: ``ops/conv_int8.py``,
``ops/depthwise_int8.py``, ``ops/shortcut_int8.py``, ``compress/quant.py``
and ``models/int8_engine.py`` import from it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import activations as act_mod

# activation codes of csrc/epilogue_int8.cuh (K2 and K4)
ACT_CODES = {'linear': 0, 'none': 0, '': 0, 'leaky': 1, 'relu': 2,
             'relu6': 3, 'mish': 4, 'swish': 5, 'logistic': 6, 'h_swish': 7,
             'h_sigmoid': 8}


def f32(v) -> np.float32:
    """A Python or 0-d tensor scalar rounded once to f32."""
    return np.float32(v.item() if torch.is_tensor(v) else v)


def round_half_away(x):
    """sign(x) * floor(|x| + 0.5): ties go away from zero (``torch.round``
    rounds them to even and is wrong here)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def out_multiplier(out_scale, out_mult=None) -> np.float32:
    """The f32 multiplier of the requant: ``out_mult`` rounded once to f32
    when the caller gives it, else f32(1) / f32(out_scale)."""
    if out_mult is not None:
        return f32(out_mult)
    return np.float32(1.0) / f32(out_scale)


def epilogue(acc, bias, scale, out_scale, act, maxabs, out_q, qmin, qmax,
             out_mult=None):
    """K2's f32 epilogue on s32 sums ``acc`` (NHWC): act(f32(acc) * scale +
    bias), then int8 codes clip(round_half_away(y * oinv), qmin, qmax)
    where ``out_q``, else y in f32."""
    # 0-d f32 tensors filled on the device: no copy from the host, which a
    # CUDA graph's capture would refuse
    dev = acc.device
    s = torch.full((), f32(scale), dtype=torch.float32, device=dev)
    y = acc.to(torch.float32) * s + bias.to(torch.float32)
    y = act_mod.get(act, maxabs)(y)
    if not out_q:
        return y.contiguous()
    oinv = torch.full((), out_multiplier(out_scale, out_mult),
                      dtype=torch.float32, device=dev)
    q = torch.clamp(round_half_away(y * oinv), qmin, qmax)
    return q.to(torch.int8).contiguous()


def grouped_conv_s32(x8, w8, *, stride, pad, groups: int):
    """The exact s32 sums of an int8 conv of any window, stride, padding
    and group count, in plain PyTorch on every device: x8 int8 NHWC, w8
    int8 (Cout, K, K, Cin // groups), zero padding ``pad`` (an int, or a
    (py, px) pair: (0, pad) on a block of rows with its halo), ``stride``
    an int or an (sy, sx) pair; returns int32 NHWC. The sums are int32
    products of shifted int8 slices, added tap by tap over the K x K
    window: exact by construction, with no float conv algorithm between (a
    cuDNN f32 conv may pick Winograd or FFT, which are not exact)."""
    sy, sx = (stride, stride) if isinstance(stride, int) else stride
    py, px = (pad, pad) if isinstance(pad, int) else pad
    n, h, w, cin = x8.shape
    cout, kh, kw, cg = w8.shape
    og = cout // groups
    if cin != cg * groups or cout != og * groups:
        raise ValueError(f'grouped_conv_s32: x8 {tuple(x8.shape)} and w8 '
                         f'{tuple(w8.shape)} do not match groups={groups}')
    ho = (h + 2 * py - kh) // sy + 1
    wo = (w + 2 * px - kw) // sx + 1
    xp = F.pad(x8.to(torch.int32), (0, 0, px, px, py, py))
    wg = w8.to(torch.int32).reshape(groups, og, kh, kw, cg)
    acc = torch.zeros((n, ho, wo, groups, og), dtype=torch.int32,
                      device=x8.device)
    for dy in range(kh):
        for dx in range(kw):
            xs = xp[:, dy:dy + sy * (ho - 1) + 1:sy,
                    dx:dx + sx * (wo - 1) + 1:sx]
            if cg == 1:                  # depthwise: one multiply-add
                acc.addcmul_(xs.reshape(n, ho, wo, groups, 1),
                             wg[:, :, dy, dx, 0])
            else:
                prod = xs.reshape(n, ho, wo, groups, 1, cg) * wg[:, :, dy, dx]
                acc += prod.sum(-1, dtype=torch.int32)
    return acc.reshape(n, ho, wo, cout)
