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
from .._build import load_library

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
            float(np.float32(1.0) / _f32(out_scale)), act,
            0.25 if maxabs else 0.1, out_q, qmin, qmax, plan.bn, plan.stages,
            plan.rows)
    return out


def _launch(x8, w8, bias, out, stride, scale, oinv, act, slope, out_q, qmin,
            qmax, bn, stages, rows):
    """One launch of the kernel with the given tiles (BN, ring stages, the
    run of bytes) on checked, Cin-padded, 16-byte aligned CUDA tensors;
    adds one to ``fused_conv_int8.launches``, or raises if the launch is
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
    fused_conv_int8.launches += 1


fused_conv_int8.launches = 0
