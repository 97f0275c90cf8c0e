"""Spatial ops of the detector: conv, batch norm, pooling, upsample.

Counterpart of ``yolo_tpu/ops/conv.py``. Tensors are NCHW in PyTorch's
sense and kept in ``channels_last`` memory, so ``x.permute(0, 2, 3, 1)`` is
the JAX package's NHWC array without a copy; weights are OIHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x, w, *, stride=1, padding: int = 0, groups: int = 1, bias=None):
    """Grouped 2-D convolution; ``stride`` is an int or an (sy, sx) pair and
    ``w`` is OIHW with I = in_channels // groups."""
    return F.conv2d(x, w, bias, stride=stride, padding=padding, groups=groups)


def batch_norm_infer(x, gamma, beta, mean, var, eps: float = 1e-5):
    """Inference BN with running statistics: the per-channel scale and shift
    are computed in f32, then cast to the activation dtype."""
    gamma, beta, mean, var = (t.to(torch.float32)
                              for t in (gamma, beta, mean, var))
    scale = gamma * torch.rsqrt(var + eps)
    shift = beta - mean * scale
    return (x * scale.to(x.dtype)[:, None, None]
            + shift.to(x.dtype)[:, None, None])


# eps and momentum of the per-conv BN and of the standalone [batchnorm]
# block (as in the JAX package)
CONV_BN_EPS, CONV_BN_MOM = 1e-5, 0.1
LONE_BN_EPS, LONE_BN_MOM = 1e-4, 0.03


def batch_norm_train(x, gamma, beta, running_mean, running_var,
                     eps: float = 1e-5, momentum: float = 0.1):
    """Training-mode BN over (N, H, W) of an NCHW tensor, in plain tensor
    ops so that autograd gives the JAX package's VJP (``F.batch_norm``
    would follow cuDNN's rules for the variance and the running update).

    Returns (y, new_running_mean, new_running_var), the running ones
    detached. The statistics are f32 (f64 for an f64 input, which serves
    as a reference); y is cast back to x's dtype. y uses the biased batch
    variance, the running variance the unbiased one, and running = (1 -
    momentum) * running + momentum * batch. An f32 or f64 input takes the
    two-pass variance; a bf16 one the one-pass ``E[x^2] - mean^2``,
    clamped at 0, as in the JAX package (the one-pass form cancels when
    |mean| >> std, which f32 parity cannot afford)."""
    n = x.shape[0] * x.shape[2] * x.shape[3]
    axes = (0, 2, 3)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(axes)
    c = lambda t: t[:, None, None]
    if x.dtype == xf.dtype:
        var = (xf - c(mean)).square().mean(axes)
    else:
        var = torch.clamp_min(xf.square().mean(axes) - mean.square(), 0.0)
    y = ((xf - c(mean)) * c(torch.rsqrt(var + eps)) * c(gamma)
         + c(beta)).to(x.dtype)
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


def max_pool(x, size: int, stride: int):
    """Darknet maxpool: -inf padding of (size - 1) // 2, except the tiny
    k=2/s=1 case, which pads one zero row and column at the bottom/right."""
    if size == 2 and stride == 1:
        return F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
    return F.max_pool2d(x, size, stride, padding=(size - 1) // 2)


def space_to_depth(x, stride: int):
    """(N, C, H, W) -> (N, s*s*C, H/s, W/s) with output channel
    ``(sy*s + sx)*C + c``, the NHWC order of the JAX package (not
    ``pixel_unshuffle``'s ``c*s*s + sy*s + sx``)."""
    n, c, h, w = x.shape
    s = stride
    y = x.permute(0, 2, 3, 1).reshape(n, h // s, s, w // s, s, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // s, w // s, s * s * c)
    return y.permute(0, 3, 1, 2)


def upsample_nearest(x, scale: int):
    """Nearest-neighbour upsample by an integer factor; the result is in
    channels_last memory."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :]
    y = y.expand(n, h, scale, w, scale, c).reshape(n, h * scale, w * scale, c)
    return y.permute(0, 3, 1, 2)


def se_block(x, fc1_w, fc2_w):
    """Squeeze-and-excitation with a hard-sigmoid gate: the mean over H, W,
    ``relu(y @ fc1.T) @ fc2.T``, then ``clip(y + 3, 0, 6) / 6`` scales the
    channels. The fc weights are in ``Linear`` layout (out, in). The gate is
    computed in f32 and cast to x's dtype."""
    y = x.to(torch.float32).mean((2, 3))                          # (n, c)
    y = torch.relu(y @ fc1_w.to(torch.float32).T)
    y = y @ fc2_w.to(torch.float32).T
    y = torch.clamp(y + 3.0, 0.0, 6.0) / 6.0
    return x * y.to(x.dtype)[:, :, None, None]


def global_avg_pool(x):
    """The [avgpool] layer: the mean over H, W to 1x1, taken in f32 and cast
    back to x's dtype."""
    return x.to(torch.float32).mean((2, 3), keepdim=True).to(x.dtype)


def mixconv2d(x, weights, *, stride: int = 1):
    """MixConv: one conv per OIHW kernel of odd size k, 'same' padding
    k // 2, outputs concatenated along the channels."""
    return torch.cat([conv2d(x, w, stride=stride, padding=w.shape[-1] // 2)
                      for w in weights], 1)


def mixconv_channel_split(out_ch: int, ks=(3, 5, 7), method='equal_params'):
    """Output channels of each MixConv branch: 'equal_ch' splits them
    evenly, 'equal_params' solves for an equal parameter count."""
    groups = len(ks)
    if method == 'equal_ch':
        i = np.floor(np.linspace(0, groups - 1e-6, out_ch))
        return [int((i == g).sum()) for g in range(groups)]
    b = [out_ch] + [0] * groups
    a = np.eye(groups + 1, groups, k=-1)
    a -= np.roll(a, 1, axis=1)
    a *= np.array(ks) ** 2
    a[0] = 1
    return np.linalg.lstsq(a, b, rcond=None)[0].round().astype(int).tolist()


def fuse_conv_bn(w, b, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold inference BN into an OIHW conv: returns (w_fused, b_fused)."""
    scale = gamma / torch.sqrt(var + eps)
    w_f = w * scale[:, None, None, None]
    if b is None:
        b = torch.zeros_like(mean)
    return w_f, (b - mean) * scale + beta


# NHWC forms, for the quantized paths (compress/quant.py, int8_engine.py),
# which keep the JAX package's layout end to end

def conv2d_nhwc(x, w, *, stride=1, padding: int = 0, groups: int = 1,
                bias=None):
    """``conv2d`` on an NHWC tensor with an OIHW weight; returns NHWC (a
    view of the channels_last result)."""
    y = conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding,
               groups=groups, bias=bias)
    return y.permute(0, 2, 3, 1)


def max_pool_nhwc(x, size: int, stride: int):
    """``max_pool`` on an NHWC tensor. An int8 tensor is pooled in f32 (int8
    values are exact there) and cast back, so it works on every device;
    the -inf padding of the general case then never wins a window, as the
    int8 minimum pad of the JAX package never does."""
    xf = x.to(torch.float32) if x.dtype == torch.int8 else x
    y = max_pool(xf.permute(0, 3, 1, 2), size, stride).permute(0, 2, 3, 1)
    return y.to(torch.int8).contiguous() if x.dtype == torch.int8 else y


def se_block_nhwc(x, fc1_w, fc2_w):
    """``se_block`` on an NHWC tensor; returns NHWC."""
    return se_block(x.permute(0, 3, 1, 2), fc1_w, fc2_w).permute(0, 2, 3, 1)


def global_avg_pool_nhwc(x):
    """``global_avg_pool`` on an NHWC tensor: (n, 1, 1, c)."""
    return global_avg_pool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def upsample_nearest_nhwc(x, scale: int):
    """Nearest-neighbour upsample of an NHWC tensor (any dtype); contiguous."""
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return y.reshape(n, h * scale, w * scale, c)


def space_to_depth_nhwc(x, stride: int):
    """NHWC space-to-depth (the [reorg3d] layer): output channel
    ``(sy*s + sx)*C + c``; contiguous, any dtype."""
    n, h, w, c = x.shape
    s = stride
    y = x.reshape(n, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h // s, w // s, s * s * c)
