"""K2, the fused int8 conv: a CUDA kernel and its plain PyTorch twin.

``fused_conv_int8`` is the counterpart of
``yolo_tpu/ops/pallas_conv.py::fused_conv_int8``:

    acc = conv_s32(x8, w8)                    (s8 x s8, exact s32 sums)
    y   = act(f32(acc) * scale + bias)        (f32, no multiply-add fusion)
    out = clip(round_half_away(y * oinv), qmin, qmax) -> int8
          (``out_q``), else y in f32

with ``oinv`` = f32(1) / f32(out_scale), or the caller's own output
multiplier ``out_mult`` rounded once to f32 (TPSQ's requant multiplier
(qmax / (qmax + 1)) / out_scale is not a power of two: it must be formed
as one quotient and rounded once, as the JAX engine forms it),

with x8 int8 NHWC, w8 int8 (Cout, K, K, Cin) (OHWI: Cin innermost, the
order the kernel reads), bias f32[Cout], ``scale`` and ``out_scale``
per-tensor f32 scalars, pad K // 2, groups 1.

On a CUDA tensor it launches ``csrc/conv_int8.cu`` (an implicit GEMM on
Hopper's s8 tensor cores, ``wgmma`` fed by a ring of shared-memory tiles;
persistent blocks walk tiles of 128 output pixels x BN output channels,
BN from ``tile_plan``) or raises; on a CPU tensor it runs
``fused_conv_int8_reference``. There is no fallback from CUDA to the plain
version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import activations as act_mod
from . import conv as conv_ops
from .._build import load_library
from ..utils.profiler import count

# activation codes of csrc/conv_int8.cu
ACT_CODES = {'linear': 0, 'none': 0, '': 0, 'leaky': 1, 'relu': 2,
             'relu6': 3, 'mish': 4, 'swish': 5, 'logistic': 6, 'h_swish': 7,
             'h_sigmoid': 8}

# the kernel's tiles (csrc/conv_int8.cu)
BM = 128             # output pixels per block: two warpgroups of 64 rows
BK = 128             # reduction bytes per ring stage: one 128-byte swizzle row
CIN_GRANULE = 16     # Cin is zero-padded to a multiple of this (16-byte copies)
BN_CHOICES = (256, 128, 64, 32)      # output channels per block (the
                                     # kernel's instantiations)
SLAB_BYTES = BM * 36 * 4  # the epilogue's s32 slab: BM rows of 32 (+4) words
SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100


class TilePlan(NamedTuple):
    bn: int              # output channels per block
    stages: int          # depth of the shared-memory ring
    smem: int            # bytes of dynamic shared memory per block
    grid: tuple          # (pixel tiles, channel tiles)
    ktot: int            # reduction length K*K*Cin (Cin padded), in bytes
    rows: bool           # each tile's output built as one run of bytes


def run_tile(cout: int, bn: int, out_q: bool) -> bool:
    """Whether the kernel is told to build each tile's output as one run of
    bytes in shared memory (int8 out, Cout not a multiple of 16, one
    channel tile: the three Cout 255 heads), to store it with aligned
    16-byte stores."""
    return out_q and cout % 16 != 0 and cout <= bn


def smem_bytes(bn: int, stages: int, run: bool = False) -> int:
    """Shared memory of a block, as ``smem_bytes`` in the kernel source
    counts it (a CPU test holds the two to each other): the ring of A
    (BM x BK) and B (BN x BK) tiles, the epilogue's slab, the tile's run of
    output bytes (``run_tile``), the mbarriers, and 1024 bytes to align
    the ring for the 128-byte swizzle."""
    return (1024 + stages * (BM * BK + bn * BK) + SLAB_BYTES
            + (BM * bn + 16 if run else 0) + 16 * stages)


@functools.lru_cache(maxsize=4096)
def tile_plan(m: int, cin: int, cout: int, k: int,
              out_q: bool = True) -> TilePlan:
    """Tiles for one conv of ``m`` output pixels, ``cin`` input and
    ``cout`` output channels and a ``k`` x ``k`` window, int8 out
    (``out_q``) or f32.

    A 3x3 conv into 128 or more channels has nine taps to sum per pixel
    and is bound by the tensor cores: BN = 256 (or 128 where Cout < 256),
    the widest wgmma that Cout fills, reads each A tile once for that many
    channels, with a ring of 4 stages. The 1x1 convs, and the 3x3 convs
    into 64 channels or fewer, are bound by bytes and latency: BN = 64 (32
    where Cout <= 32) with 3 stages, so that two blocks share an SM and
    hide each other's loads and epilogues. ``scripts/k2_sweep.py`` timed
    every (BN, stages) on the 74 int8 convs of yolov3 @608 (PERF.md): this
    rule is within a few percent of the best choice per shape. An int8
    output whose Cout is not a multiple of 16 (the heads' 255) takes one
    channel tile as wide as Cout where its pixel tiles alone give 64 blocks
    or more, so that the tile's output is one run of bytes (``run_tile``).
    The ring takes as many of its stages as fit in shared memory. The grid
    is ``m`` / BM by Cout / BN tiles. Cached: the wrapper asks it on every
    call."""
    cin_p = -(-cin // CIN_GRANULE) * CIN_GRANULE
    ktot = k * k * cin_p
    gx = -(-m // BM)
    if k == 3 and cout >= 128:
        bn, stages = (256 if cout >= 256 else 128), 4
    else:
        bn, stages = (32 if cout <= 32 else 64), 3
    if out_q and cout % 16 and cout <= BN_CHOICES[0] and gx >= 64:
        bn = min(b for b in BN_CHOICES if b >= cout)
    run = run_tile(cout, bn, out_q)
    while smem_bytes(bn, stages, run) > SMEM_LIMIT:
        stages -= 1
    grid = (gx, -(-cout // bn))
    return TilePlan(bn, stages, smem_bytes(bn, stages, run), grid, ktot, run)


def pad_cin(x8, w8):
    """Zero-pad Cin of x8 (N, H, W, Cin) and w8 (Cout, K, K, Cin) up to a
    multiple of ``CIN_GRANULE`` where it is not one (a copy, only for such
    odd widths). Exact: the zeros add nothing to the sums."""
    extra = -x8.shape[-1] % CIN_GRANULE
    if extra:
        x8 = F.pad(x8, (0, extra))
        w8 = F.pad(w8, (0, extra))
    return x8, w8


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
                              qmax: int = 127, out_mult=None):
    """Plain PyTorch version of ``fused_conv_int8`` (same contract).

    The conv runs in float64 on the int8 values: every product and partial
    sum is an integer below 2^53, so it is exact in any order, and equals
    the s32 accumulator. The epilogue repeats the kernel's f32 operations
    in the same order."""
    k = w8.shape[1]
    acc = F.conv2d(x8.permute(0, 3, 1, 2).to(torch.float64),
                   w8.permute(0, 3, 1, 2).to(torch.float64),
                   stride=stride, padding=k // 2)
    return _epilogue(acc.permute(0, 2, 3, 1).to(torch.int32), bias, scale,
                     out_scale, act, maxabs, out_q, qmin, qmax, out_mult)


def out_multiplier(out_scale, out_mult=None) -> np.float32:
    """The f32 multiplier of the requant: ``out_mult`` rounded once to f32
    when the caller gives it, else f32(1) / f32(out_scale)."""
    if out_mult is not None:
        return _f32(out_mult)
    return np.float32(1.0) / _f32(out_scale)


def _epilogue(acc, bias, scale, out_scale, act, maxabs, out_q, qmin, qmax,
              out_mult=None):
    """The kernel's f32 epilogue on s32 sums ``acc`` (NHWC)."""
    dev = acc.device
    s = torch.tensor(_f32(scale), device=dev)
    y = acc.to(torch.float32) * s + bias.to(torch.float32)
    y = act_mod.get(act, maxabs)(y)
    if not out_q:
        return y.contiguous()
    oinv = torch.tensor(out_multiplier(out_scale, out_mult), device=dev)
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


def grouped_conv_int8(x8, w8, bias, scale, out_scale, *, stride, pad,
                      groups: int, act: str = 'leaky', maxabs: bool = False,
                      qmin: int = -128, qmax: int = 127, out_mult=None):
    """The int8 convs K2 does not take (depthwise and grouped ones, other
    windows, strides or paddings; ``pad`` and ``stride`` as
    ``grouped_conv_s32`` takes them), with K2's f32 epilogue into int8 (the
    JAX package runs these through XLA's s8 conv with s32 sums and the same
    epilogue). A depthwise conv on the card that K4 takes
    (``depthwise_int8.takes``: ``groups`` == Cin == Cout, a square window
    of 1, 3, 5 or 7, strides 1 or 2; every grouped conv of the cfgs)
    launches K4 (``depthwise_int8.fused_depthwise_int8``); every other
    conv, and every conv on the CPU, runs ``grouped_conv_s32`` and the
    epilogue in plain PyTorch. Each call adds one to
    ``grouped_conv_int8.calls`` and to the counter ``grouped.calls``."""
    if x8.is_cuda and depthwise_int8.takes(x8, w8, groups, stride, pad):
        out = depthwise_int8.fused_depthwise_int8(
            x8, w8, bias, scale, out_scale, stride=stride, pad=pad, act=act,
            maxabs=maxabs, qmin=qmin, qmax=qmax, out_mult=out_mult)
    else:
        acc = grouped_conv_s32(x8, w8, stride=stride, pad=pad, groups=groups)
        out = _epilogue(acc, bias, scale, out_scale, act, maxabs, True, qmin,
                        qmax, out_mult)
    grouped_conv_int8.calls += 1
    count('grouped.calls', 1)
    return out


grouped_conv_int8.calls = 0


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
                    out_q: bool = True, qmin: int = -128, qmax: int = 127,
                    out_mult=None):
    """Quantized conv: int8 NHWC x int8 (Cout, K, K, Cin) -> int8 NHWC
    (``out_q``) or f32 NHWC. ``qmin``/``qmax`` bound the output grid;
    ``out_mult`` is the requant multiplier when the caller forms it (see
    the module docstring), else 1 / ``out_scale``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (each launch adds one to the counter ``k2.launches``) or raises."""
    if x8.device.type == 'cpu':
        return fused_conv_int8_reference(x8, w8, bias, scale, out_scale,
                                         stride=stride, act=act, maxabs=maxabs,
                                         out_q=out_q, qmin=qmin, qmax=qmax,
                                         out_mult=out_mult)
    if x8.device.type != 'cuda':
        raise ValueError(f'fused_conv_int8: no kernel for device {x8.device}')
    _check(x8, w8, bias, stride, act, qmin, qmax)
    x8, w8 = pad_cin(x8, w8)
    # the kernel reads x8, w8 and bias in 16-byte pieces (cp.async, TMA,
    # vector loads)
    x8, w8, bias = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (x8, w8, bias))
    n, h, w, cin = x8.shape
    cout, k = w8.shape[0], w8.shape[1]
    pad = k // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    out = torch.empty((n, ho, wo, cout),
                      dtype=torch.int8 if out_q else torch.float32,
                      device=x8.device)
    if out.numel() == 0:
        return out
    plan = tile_plan(n * ho * wo, cin, cout, k, out_q)
    _launch(x8, w8, bias, out, stride, float(_f32(scale)),
            float(out_multiplier(out_scale, out_mult)), act,
            0.25 if maxabs else 0.1, out_q, qmin, qmax, plan.bn, plan.stages,
            plan.rows)
    return out


def _launch(x8, w8, bias, out, stride, scale, oinv, act, slope, out_q, qmin,
            qmax, bn, stages, rows):
    """One launch of the kernel with the given tiles (BN, ring stages, the
    run of bytes) on checked, Cin-padded, 16-byte aligned CUDA tensors;
    adds one to the counter ``k2.launches``, or raises if the launch is
    refused."""
    lib = load_library()
    n, h, w, cin = x8.shape
    cout, k = w8.shape[0], w8.shape[1]
    ho, wo = out.shape[1], out.shape[2]
    dev = x8.device.index
    err = lib.conv_int8_launch(
        x8.data_ptr(), w8.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, h, w, cin, cout, k, stride, k // 2, ho, wo, scale, oinv,
        ACT_CODES[act], slope, int(bool(out_q)), int(qmin), int(qmax),
        bn, stages, int(bool(rows)), dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError('conv_int8 kernel launch failed: '
                           + lib.conv_int8_error_string(err).decode())
    count('k2.launches', 1)


def k2_rows(x8, w8, bias, scale, out_scale, *, stride: int, group,
            conv=fused_conv_int8, **kw):
    """``conv`` (K2, or its plain twin) on this rank's rows of an int8 NHWC
    edge whose H is split over ``group``. A 1x1 conv runs on the rows as
    they are. K2 pads every side of a 3x3 conv by 1, H as W (the kernel is
    unchanged): output j of a block whose first row is global row b reads
    global rows b - 1 + s*j .. b + 1 + s*j at stride s, and darknet's
    output i reads rows s*i - 1 .. s*i + 1. So the block starts s rows
    over this rank's first row r0 (a multiple of s, as every rank's rows
    are) and its output 1 is this rank's first: stride 1 takes one row over and one
    under from the neighbours, stride 2 two over and none under (the
    image's top and bottom code 0, the value 0 of the symmetric grids).
    Output 0, and stride 1's last, read the block's own padding and are
    cropped: output rows 1 .. rows / s are this rank's rows of the whole
    image's output."""
    if w8.shape[1] == 1:
        return conv(x8, w8, bias, scale, out_scale, stride=stride, **kw)
    n = x8.shape[1]
    if n % stride:
        raise ValueError(f'{n} rows of a rank do not split at stride '
                         f'{stride}')
    above, below = (1, 1) if stride == 1 else (2, 0)
    y = conv(conv_ops.rows_with_halo_nhwc(x8, above, below, group, 0), w8,
             bias, scale, out_scale, stride=stride, **kw)
    return y[:, 1:1 + n // stride].contiguous()


def float_edge_conv(x, w8, bias, sw, sa, *, stride, pad, groups: int,
                    act: str, maxabs: bool, qmin: int, qmax: int,
                    out_mult=None):
    """A conv on a float edge (f32 NHWC ``x``) into an int8 edge of scale
    ``sa``: the conv of the bf16-rounded input with the dequantized int8
    weights (exact in bf16), summed and kept in f32, then bias, activation
    and requantization. That is the JAX engine as its jitted program
    computes it: XLA keeps the bf16 conv's f32 sums without rounding them
    to bf16 (its eager op does round them). ``pad``: an int or a (py, px)
    pair ((0, pad) on a block of rows with its halo). Each call adds one to
    ``float_edge_conv.calls`` and to the counter ``float_edge.calls``.
    ``out_mult``: the requant multiplier (a
    Python float, as the JAX engine's), else 1 / ``sa``."""
    wf = w8.permute(0, 3, 1, 2).to(torch.float32) * sw
    xb = x.to(torch.bfloat16).to(torch.float32)
    y = conv_ops.conv2d_nhwc(xb, wf, stride=stride, padding=pad,
                             groups=groups)
    y = act_mod.get(act, maxabs)(y + bias)
    q = torch.clamp(round_half_away(y * (1.0 / sa if out_mult is None
                                         else out_mult)), qmin, qmax)
    float_edge_conv.calls += 1
    count('float_edge.calls', 1)
    return q.to(torch.int8).contiguous()


float_edge_conv.calls = 0


# K4 builds on this module's s32 sums and epilogue (its plain twin), so it
# is imported once they are defined
from . import depthwise_int8  # noqa: E402
