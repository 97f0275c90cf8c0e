"""Spatial ops of the detector: conv, batch norm, pooling, upsample.

Counterpart of ``yolo_tpu/ops/conv.py``. Tensors are NCHW in PyTorch's
sense and kept in ``channels_last`` memory, so ``x.permute(0, 2, 3, 1)`` is
the JAX package's NHWC array without a copy; weights are OIHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_nograd, batch_moments, halo_rows


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
                     eps: float = 1e-5, momentum: float = 0.1, group=None):
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
    |mean| >> std, which f32 parity cannot afford).

    ``group``: the data group of a data-parallel step
    (``parallel.Mesh.data_group``); the statistics, and ``n`` of the
    unbiased running variance, are then the global batch's, through
    differentiable all-reduces (two for the two-pass form, one for the
    one-pass form), and the running statistics come out equal on every
    rank."""
    axes = (0, 2, 3)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = lambda t: t[:, None, None]
    if group is not None:
        mean, var, n = batch_moments(xf, axes, group,
                                     one_pass=x.dtype != xf.dtype)
    else:
        n = x.shape[0] * x.shape[2] * x.shape[3]
        mean = xf.mean(axes)
        if x.dtype == xf.dtype:
            var = (xf - c(mean)).square().mean(axes)
        else:
            var = torch.clamp_min(xf.square().mean(axes) - mean.square(),
                                  0.0)
    y = ((xf - c(mean)) * c(torch.rsqrt(var + eps)) * c(gamma)
         + c(beta)).to(x.dtype)
    with torch.no_grad():
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * unbiased
    return y, new_mean, new_var


def max_pool(x, size: int, stride: int):
    """Darknet maxpool: -inf padding of (size - 1) // 2, except the tiny
    k=2/s=1 case, which pads one zero row and column at the bottom/right.
    An int8 tensor is pooled in f32 and cast back: its values are exact
    there, so it works on every device, and the -inf padding, which has
    no int8 code, never wins a window (as the int8 minimum pad of the JAX
    package never does)."""
    if x.dtype == torch.int8:
        return max_pool(x.to(torch.float32), size, stride).to(torch.int8)
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


def _mean_hw(x, group):
    """The f32 mean over H, W; under ``group`` (the rows split over its
    ranks) the sum over the group's rows, over their count."""
    xf = x.to(torch.float32)
    if group is None:
        return xf.mean((2, 3))
    n = x.shape[2] * x.shape[3] * torch.distributed.get_world_size(group)
    return all_reduce_nograd(xf.sum((2, 3)), group) / n


def se_block(x, fc1_w, fc2_w, group=None):
    """Squeeze-and-excitation with a hard-sigmoid gate: the mean over H, W,
    ``relu(y @ fc1.T) @ fc2.T``, then ``clip(y + 3, 0, 6) / 6`` scales the
    channels. The fc weights are in ``Linear`` layout (out, in). The gate is
    computed in f32 and cast to x's dtype. ``group``: x holds this rank's
    rows of the image, the mean is the whole image's."""
    y = _mean_hw(x, group)                                        # (n, c)
    y = torch.relu(y @ fc1_w.to(torch.float32).T)
    y = y @ fc2_w.to(torch.float32).T
    y = torch.clamp(y + 3.0, 0.0, 6.0) / 6.0
    return x * y.to(x.dtype)[:, :, None, None]


def global_avg_pool(x, group=None):
    """The [avgpool] layer: the mean over H, W to 1x1, taken in f32 and cast
    back to x's dtype (of the whole image under ``group``, as
    ``se_block``)."""
    return _mean_hw(x, group)[:, :, None, None].to(x.dtype)


# spatial partitioning: a tensor holds one rank's rows of the image, the
# ranks of ``group`` in order (parallel.shard_spatial). The row rules below
# serve the float forward (NCHW, models/network.py), the fake-quant sim and
# the int8 engine (NHWC, compress/quant.py, models/int8_engine.py) alike

class RowSplit:
    """Which tensors of one forward pass hold this rank's rows of the
    image, split over ``group``, and which are whole on every rank. A
    global pool's output is whole, and so is every layer after it that
    reads only whole tensors (the 1x1 convs of an SE-like branch), until a
    layer reads rows again (``scale_channels``, a shortcut or a route onto
    a split tensor). ``group`` None: one process, nothing is split."""

    def __init__(self, group):
        self.group = group
        self.whole = False
        self.rep = set()        # the routed outputs that are whole

    @property
    def split(self):
        """The group over whose ranks the current tensor's rows are split,
        or None where it is whole."""
        return None if self.whole else self.group

    def after(self, lyr):
        """Note that ``lyr`` has run; call once after each layer."""
        if self.group is None:
            return
        kind = lyr.kind
        if kind == 'avgpool':
            self.whole = True
        elif kind == 'scale_channels':
            self.whole = self.whole and lyr.layers[0] in self.rep
        elif kind == 'shortcut':
            self.whole = self.whole and all(j in self.rep for j in lyr.layers)
        elif kind == 'route' and (len(lyr.layers) > 1
                                  or not lyr.route_groups):
            self.whole = all(j in self.rep for j in lyr.layers)
        if lyr.is_routed and self.whole:
            self.rep.add(lyr.index)


def halo_extent(size: int, stride: int, pad: int):
    """The rows a window of ``size`` rows at ``stride`` with ``pad`` rows of
    padding reads from its neighbours: ``pad`` over and ``max(size - stride
    - pad, 0)`` under (a 3x3 conv: one each side; 3x3 stride 2: one over;
    SPP's 5/9/13 maxpools: 2/4/6 each side)."""
    return pad, max(size - stride - pad, 0)


def rows_with_halo_nhwc(x, above: int, below: int, group, fill=0.0):
    """This rank's rows of an NHWC tensor with ``above`` rows over and
    ``below`` rows under from its neighbours, the image's own top and
    bottom taking ``fill`` (any dtype: an int8 edge takes an int8 code)."""
    if not (above or below):
        return x
    over, under = halo_rows(x, above, below, group, fill)
    return torch.cat([over, x, under], 1)


def rows_with_halo(x, size: int, stride: int, pad: int, group,
                   fill: float = 0.0):
    """This rank's rows of an NCHW tensor with the halo rows that a window
    of ``size`` rows at ``stride`` with ``pad`` rows of padding reads
    (``halo_extent``); the image's own top and bottom take ``fill`` (the
    padding). Run the window with no padding over H after this."""
    return rows_with_halo_nhwc(x.permute(0, 2, 3, 1),
                               *halo_extent(size, stride, pad), group,
                               fill).permute(0, 3, 1, 2)


def conv_rows_nhwc(x, size: int, stride, pad: int, group):
    """A conv's input and padding on this rank's rows of an NHWC tensor of
    any dtype: the rows with the window's halo (zero rows at the image's
    top and bottom; on an int8 edge code 0, the value 0 of the symmetric
    grids) and the padding ``(0, pad)``, H's being in the halo.
    ``stride``: an int or an (sy, sx) pair. Without a group, (x, pad)."""
    if group is None:
        return x, pad
    sy = stride[0] if isinstance(stride, tuple) else stride
    return (rows_with_halo_nhwc(x, *halo_extent(size, sy, pad), group, 0),
            (0, pad))


def conv_rows(x, size: int, stride, pad: int, group):
    """``conv_rows_nhwc`` of an NCHW tensor."""
    x, pad = conv_rows_nhwc(x.permute(0, 2, 3, 1), size, stride, pad, group)
    return x.permute(0, 3, 1, 2), pad


def max_pool_rows(x, size: int, stride: int, group):
    """``max_pool`` of this rank's rows of an NCHW tensor: the halo of the
    window with -inf padding; tiny's k=2/s=1 pool takes one row from under,
    and the last rank the zero row of its padding. An int8 tensor is
    pooled in f32 and cast back, as ``max_pool`` pools one: the -inf halo
    rows have no int8 code."""
    if x.dtype == torch.int8:
        return max_pool_rows(x.to(torch.float32), size, stride,
                             group).to(torch.int8)
    if size == 2 and stride == 1:
        _, under = halo_rows(x.permute(0, 2, 3, 1), 0, 1, group, 0.0)
        return F.max_pool2d(F.pad(torch.cat([x, under.permute(0, 3, 1, 2)],
                                            2), (0, 1, 0, 0)), 2, 1)
    pad = (size - 1) // 2
    x = rows_with_halo(x, size, stride, pad, group, float('-inf'))
    return F.max_pool2d(x, size, stride, padding=(0, pad))


def resize_rows(x, size, group):
    """Bilinear resize (half-pixel centres, no antialias) of this rank's
    rows to its rows of an (H, W) grid ``size`` of the whole image. An
    upsample reads one source row over and under (the edge row itself at
    the image's top and bottom, where the resize clamps), then keeps the
    rows of this rank; a downsample by an integer factor reads none."""
    h, w = size
    if h <= x.shape[2]:
        return F.interpolate(x, size=(h, w), mode='bilinear',
                             align_corners=False)
    f = h // x.shape[2]
    n, r = torch.distributed.get_world_size(group), \
        torch.distributed.get_rank(group)
    over, under = (t.permute(0, 3, 1, 2) for t in
                   halo_rows(x.permute(0, 2, 3, 1), 1, 1, group))
    over = x[:, :, :1] if r == 0 else over
    under = x[:, :, -1:] if r == n - 1 else under
    ext = torch.cat([over, x, under], 2)
    y = F.interpolate(ext, size=(ext.shape[2] * f, w), mode='bilinear',
                      align_corners=False)
    return y[:, :, f:f + h]


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


def max_pool_nhwc(x, size: int, stride: int, group=None):
    """``max_pool`` on an NHWC tensor (any dtype, int8 included), or
    ``max_pool_rows`` on this rank's rows under ``group``; contiguous."""
    xc = x.permute(0, 3, 1, 2)
    y = (max_pool(xc, size, stride) if group is None
         else max_pool_rows(xc, size, stride, group))
    return y.permute(0, 2, 3, 1).contiguous()


def se_block_nhwc(x, fc1_w, fc2_w, group=None):
    """``se_block`` on an NHWC tensor; returns NHWC."""
    return se_block(x.permute(0, 3, 1, 2), fc1_w, fc2_w,
                    group=group).permute(0, 2, 3, 1)


def global_avg_pool_nhwc(x, group=None):
    """``global_avg_pool`` on an NHWC tensor: (n, 1, 1, c)."""
    return global_avg_pool(x.permute(0, 3, 1, 2),
                           group=group).permute(0, 2, 3, 1)


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
