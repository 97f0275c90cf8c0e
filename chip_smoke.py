#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``yolo_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and nothing runs on the CPU instead
(the CPU only computes the reference side of an explicit comparison):

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
   TF32 is turned off for matmuls and cuDNN convs, so every f32 comparison
   below is a true f32 comparison.
2. build: compiles ``yolo_tpu_torch/csrc/*.cu`` from the checkout (one nvcc
   per source, started together) into ``yolo_tpu_torch/_build/`` and prints
   the seconds it took.
3. K1: the NMS suppression kernel against its plain PyTorch version on
   the card: bs=8 heavy-overlap candidates at k = 512, 300, 256 with and
   without merge, plus an all-invalid batch. ``keep`` must be bit-equal and
   the merged boxes within rtol 1e-5 / atol 1e-4 where kept. Prints the
   median CUDA-event times of both at k=512, bs=8, and the bound.
4. float pipeline: ``cfg/yolov3/yolov3.cfg`` at full width, 608x608, random
   weights from a seed, through ``load_model(device='cuda').fuse()
   .make_infer()``, bf16, channels_last, bs=8, dense and sparse decode, at
   the eval threshold conf 0.001 so that the candidate buffer fills. K1's
   launch count is zeroed just before that run and must have risen after
   it. Then, on the same heads, kernel NMS and plain NMS must agree
   (rtol 1e-5 / atol 1e-4), and at bs=1 the card's f32 heads must match the
   CPU's f32 heads (rtol 1e-3 / atol 1e-3: f32 convs summed in other orders
   over 75 layers), and the bf16 heads the card's f32 heads within 10% of
   the head's largest magnitude. Prints images/s of both decodes, timed in
   turns, and the time of the forward and of decode + NMS alone.
5. K2: the fused int8 conv kernel against its plain PyTorch version on the
   card: 1x1 s1, 3x3 s1 and s2, odd H/W, Cin not a multiple of 4 with Cout
   255, int8 and f32 outputs, leaky / linear / relu / mish / leaky under
   maxabsscaler. Outputs must be bit-equal, except with mish (the kernel's
   and PyTorch's tanh/exp may differ by an ulp): there at most 1 LSB apart,
   and the share that differs is printed. Prints the median CUDA-event
   times of both, the bound, and ``torch._int_mm`` on the same product
   beside the 1x1 shape, at three yolov3 @608 bs=8 shapes.
6. int8 serving: yolov3 @608 at full width, bs=8, random weights from a
   seed, ``load_model(quantized=1, device='cuda')`` with zero BN running
   statistics (the first calibration batch is copied in), 3 calibration
   steps on the card (``apply(x, train=True)``, ``QuantConfig(steps=100)``),
   then ``make_infer()`` (the int8 engine into the sparse NMS on int8
   heads). K1's and K2's counts are zeroed just before one batch and must
   read 1 and 74 (75 convs less the float stem) after it; more than 0 valid
   candidates must reach K1. The engine through K2 must give int8 heads
   bit-equal to the same engine through K2's plain version, and at conf
   0.1 its survivor count must lie within max(2, 20%) of the f32
   fake-quant sim's on the card (requant rounding, as the JAX package's
   test allows); the head difference to the sim is printed in quanta. Then every K2 call of
   that batch is timed alone on its own inputs, beside its plain version
   and its bound, and the int8 pipeline is timed in turns with the bf16
   float pipeline on the same weights, and profiled (device time by kernel
   group). Prints the peak device memory.

The line before the last is a JSON object with each kernel's launches on
the main paths, error, times and bound; the line before it the card's name
and power limit; the last line is the JSON device record. At the end the
run checks that neither jax nor OpenCV nor any module of the JAX package
``yolo_tpu`` was imported.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, 'cfg', 'yolov3', 'yolov3.cfg')
BS, SIZE = 8, 608
CONV_SCALE = 0.7          # see yolo_tpu_torch.models.network.init_params
CONF_THRES = 0.001        # the eval threshold: the candidate buffer fills
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
F32_HEADS_TOL = dict(rtol=1e-3, atol=1e-3)
# bf16 rounds every layer's output (8-bit mantissa) over 75 convs; a layout
# or weight error would be of the order of the head itself
BF16_HEADS_TOL = 0.1
# the quantized model's random weights: He-normal at full scale (its BN
# statistics are calibrated, so the damping of the float path is not needed)
CONV_SCALE_Q = 1.0
CALIB_STEPS = 3
# the engine against the f32 sim: survivors within max(2, 20%), the bound of
# the JAX package's test_make_infer_int8_engine, at conf 0.1: at 0.05 and
# below the random yolov3 @608 fills every max_det slot on both sides, and
# the count says nothing
SURVIVOR_TOL = 0.2
SURVIVOR_CONF = 0.1
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): the bound of
# a kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for their type
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)
    print(f'  ok: {what}')


def cuda_ms(fn, iters=20, warmup=3):
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, n_ops, ops_per_s):
    """(least time in ms, 'bytes' or 'operations'): the larger of moving
    ``n_bytes`` at the memory rate and doing ``n_ops`` at ``ops_per_s``."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_b, t_o) * 1e3, ('bytes' if t_b >= t_o else 'operations')


def candidates(rng, bs, k, dev):
    """Score-sorted candidate sets with heavy overlap, invalid rows zeroed,
    as ``_suppress_and_finalize`` hands them to the kernel."""
    cx, cy = rng.uniform(0, 200, (2, bs, k, 1))
    w, h = rng.uniform(5, 60, (2, bs, k, 1))
    boxes = np.concatenate([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    scores = np.sort(rng.uniform(0.05, 1.0, (bs, k)))[:, ::-1].copy()
    valid = torch.from_numpy(scores > 0.1).to(dev)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(dev)
    boxes = torch.where(valid[..., None], boxes, 0.0).contiguous()
    scores = (torch.from_numpy(scores.astype(np.float32)).to(dev) * valid)
    return boxes, scores.contiguous(), valid


def images(seed, bs, size):
    """uint8 NHWC images with smooth structure plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([np.sin(6 * xx), np.cos(5 * yy), np.sin(4 * (xx + yy))], -1)
    x = 127.5 + 80 * base[None] + rng.normal(0, 30, (bs, size, size, 3))
    return np.clip(x, 0, 255).astype(np.uint8)


def phase_device():
    print('[1/6] device')
    if not torch.cuda.is_available():
        raise SmokeFailure('no CUDA device: this smoke run needs the card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'  {torch.cuda.get_device_name(0)}; torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN')
    return card


def phase_build():
    print('[2/6] build')
    from yolo_tpu_torch import _build
    lib = _build.library_path()
    if lib.exists():
        lib.unlink()                      # build from the sources every run
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f'  built {lib.relative_to(ROOT)} in {secs:.2f} s')
    return secs


def phase_kernel(dev):
    print('[3/6] K1 nms_suppress vs plain version')
    from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference
    rng = np.random.default_rng(0)
    max_err = 0.0
    for k in (512, 300, 256):
        for merge in (True, False):
            boxes, scores, valid = candidates(rng, BS, k, dev)
            kw = dict(iou_thres=0.6, merge=merge)
            keep, merged = suppress(boxes, boxes, scores, valid, **kw)
            torch.cuda.synchronize()
            keep_r, merged_r = suppress_reference(boxes, boxes, scores, valid,
                                                  **kw)
            check(torch.equal(keep, keep_r),
                  f'k={k} merge={merge}: keep bit-equal '
                  f'({int(keep.sum())} of {int(valid.sum())} valid kept)')
            m = keep[..., None]
            a, b = torch.where(m, merged, 0.0), torch.where(m, merged_r, 0.0)
            err = float((a - b).abs().max())
            check(torch.allclose(a, b, **KERNEL_TOL),
                  f'k={k} merge={merge}: merged within tolerance '
                  f'(max abs err {err:.3g})')
            max_err = max(max_err, err)
    z = torch.zeros((BS, 512, 4), device=dev)
    keep, merged = suppress(z, z, torch.zeros((BS, 512), device=dev),
                            torch.zeros((BS, 512), dtype=torch.bool,
                                        device=dev), iou_thres=0.6)
    torch.cuda.synchronize()
    check(not bool(keep.any()) and bool(torch.isfinite(merged).all()),
          'all-invalid batch: nothing kept, merged finite')

    boxes, scores, valid = candidates(rng, BS, 512, dev)
    kw = dict(iou_thres=0.6, merge=True)
    ms = cuda_ms(lambda: suppress(boxes, boxes, scores, valid, **kw))
    plain_ms = cuda_ms(lambda: suppress_reference(boxes, boxes, scores, valid,
                                                  **kw))
    # the bound of these inputs: each input read once (class-offset and raw
    # boxes, scores, valid) and each output written once (keep, merged);
    # 14 f32 operations per IoU of a pair of valid candidates, 9 per
    # overlapping (i, j) of the merge and 4 divisions per valid row
    from yolo_tpu_torch.ops.boxes import box_iou_matrix
    bs, k = valid.shape
    n_bytes = bs * k * (16 + 16 + 4 + 1) + bs * k * (1 + 16)
    nv = valid.sum(1).double()
    vv = valid[:, :, None] & valid[:, None, :]
    n_over = float((vv & (box_iou_matrix(boxes, boxes) > 0.6)).sum())
    n_ops = float((nv * (nv - 1) / 2 * 14 + nv * 4).sum()) + 9 * n_over
    b_ms, b_by = bound_ms(n_bytes, n_ops, F32_OPS_PER_S)
    print(f'  k=512 bs={BS} merge: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
          f'bound {b_ms:.6f} ms by {b_by} ({n_bytes / 1e6:.3f} MB, '
          f'{n_ops / 1e6:.2f} M f32 operations: {int(nv.sum())} valid, '
          f'{int(n_over)} overlapping pairs)')
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_pipeline(dev, card):
    print('[4/6] yolov3 @608 float pipeline')
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.ops.nms_suppress import suppress

    def bundle(device, dtype):
        return runtime.load_model(
            CFG, device=device, dtype=dtype, conv_scale=CONV_SCALE,
            generator=torch.Generator().manual_seed(0)).fuse()

    b16 = bundle(dev, torch.bfloat16)
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    infer = {s: b16.make_infer(sparse=s, **kw) for s in (False, True)}
    x = runtime.preprocess(images(1, BS, SIZE), device=dev)

    suppress.launches = 0
    dets = {s: infer[s](x) for s in (False, True)}
    torch.cuda.synchronize()
    launches = suppress.launches
    check(launches == 2, f'main path launched the NMS kernel ({launches} '
          'launches for one dense and one sparse batch)')
    for s, d in dets.items():
        name = 'sparse' if s else 'dense'
        check(tuple(d.shape) == (BS, 300, 6) and bool(torch.isfinite(d).all()),
              f'{name}: detections (bs, max_det, 6), all finite')
        check(int((d[..., 4] > 0).sum()) > 0,
              f'{name}: {int((d[..., 4] > 0).sum())} detections over the batch')

    # what the kernel saw, and kernel NMS == plain NMS on the same heads
    model = b16.model()
    anchors, strides = model.anchors(), b16.strides
    with torch.inference_mode():
        heads, objs = model.forward_heads(x)
        box_xywh, obj, cls = nms._heads_candidates(
            heads, anchors, strides, b16.nc + 5, CONF_THRES, 512, objs=objs)
        valid = nms._pairs(box_xywh, obj, cls, CONF_THRES, 512, True,
                           False)[4]
        n_valid = int(valid.sum())
        check(n_valid > 0, f'{n_valid} valid candidates reach the kernel '
              f'({valid.shape[1]} slots per image)')
        for s in (False, True):
            hkw = dict(objs=objs, **kw)
            if s:
                run = lambda plain: nms.non_max_suppression_heads(
                    heads, anchors, strides, b16.nc + 5, plain=plain, **hkw)
            else:
                io = model(x)
                run = lambda plain: nms.non_max_suppression(io, plain=plain,
                                                            **kw)
            a, b = run(False), run(True)
            err = float((a - b).abs().max())
            check(torch.allclose(a, b, **KERNEL_TOL),
                  f'{"sparse" if s else "dense"}: kernel NMS == plain NMS '
                  f'(max abs err {err:.3g})')

    # f32 heads on the card (TF32 off) against the CPU, and the bf16 heads
    # of the timed path against the card's f32 heads
    x1 = runtime.preprocess(images(2, 1, SIZE), device=dev)
    with torch.inference_mode():
        h_card = bundle(dev, torch.float32).model().forward_heads(x1)[0]
        h_cpu = bundle('cpu', torch.float32).model().forward_heads(x1.cpu())[0]
        h_bf16 = model.forward_heads(x1)[0]
    for i, (a, b, c) in enumerate(zip(h_card, h_cpu, h_bf16)):
        err = float((a.cpu() - b).abs().max())
        top = float(b.abs().max())
        check(torch.allclose(a.cpu(), b, **F32_HEADS_TOL),
              f'bs=1 f32 head {i} card vs CPU (max abs err {err:.3g}, '
              f'head max {top:.3g})')
        err = float((c.float() - a).abs().max())
        check(err <= BF16_HEADS_TOL * top,
              f'bs=1 bf16 head {i} vs f32 head on the card (max abs err '
              f'{err:.3g} <= {BF16_HEADS_TOL} x head max)')

    # time of the whole pipeline, dense and sparse in turns, and of its parts
    with torch.inference_mode():
        io = model(x)
        fwd_ms = cuda_ms(lambda: model.forward_heads(x), iters=10)
        nms_ms = {False: cuda_ms(lambda: nms.non_max_suppression(io, **kw)),
                  True: cuda_ms(lambda: nms.non_max_suppression_heads(
                      heads, anchors, strides, b16.nc + 5, objs=objs, **kw))}
    runs = {False: [], True: []}
    for s in (False, True, True, False):
        runs[s].append(cuda_ms(lambda: infer[s](x), iters=10))
    for s in (False, True):
        ms = statistics.median(runs[s])
        print(f'  {"sparse" if s else "dense"}: {ms:.3f} ms per batch of {BS} '
              f'(runs {", ".join(f"{r:.3f}" for r in runs[s])}), '
              f'{BS * 1000.0 / ms:.1f} images/s bf16 ({card}); '
              f'decode + NMS alone {nms_ms[s]:.3f} ms')
    print(f'  forward alone (bf16 heads + slim obj conv): {fwd_ms:.3f} ms '
          f'per batch of {BS}')
    return launches


# --------------------------------------------------------------- K2, int8

# (N, H, W, Cin, Cout, K, stride, act, out_q, maxabs)
K2_CASES = [
    (2, 16, 16, 32, 64, 3, 1, 'leaky', True, False),
    (2, 16, 16, 32, 64, 3, 2, 'leaky', True, False),
    (2, 19, 19, 64, 255, 1, 1, 'linear', False, False),
    (1, 13, 13, 128, 256, 3, 2, 'leaky', True, False),
    (2, 8, 8, 16, 48, 1, 1, 'relu', True, False),
    (1, 38, 38, 96, 160, 3, 1, 'mish', True, False),
    (2, 11, 13, 6, 255, 3, 1, 'leaky', True, False),
    (2, 11, 13, 6, 255, 3, 2, 'linear', True, False),
    (2, 19, 19, 64, 64, 3, 1, 'leaky', True, True),
    (2, 19, 19, 64, 64, 1, 1, 'leaky', False, True),
    (2, 19, 19, 64, 64, 3, 1, 'mish', False, False),
]
# yolov3 @608 bs=8 shapes: 3x3 s1 at 152 px, 3x3 s2 304 -> 152, 1x1 at 76 px
K2_TIMED = [(BS, 152, 152, 64, 128, 3, 1), (BS, 304, 304, 64, 128, 3, 2),
            (BS, 76, 76, 256, 128, 1, 1)]


def k2_inputs(case, dev, seed=0):
    """Random int8 input and weights, f32 bias, and scales that spread the
    outputs over the int8 range (std about 40 quanta)."""
    n, h, w, ci, co, k = case[:6]
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randint(-128, 128, (n, h, w, ci), generator=g, dtype=torch.int8)
    w8 = torch.randint(-40, 41, (co, k, k, ci), generator=g, dtype=torch.int8)
    bias = torch.randn(co, generator=g)
    scale = 2.0 ** -9
    acc_std = (k * k * ci) ** 0.5 * 74.0 * 23.4
    out_scale = 2.0 ** round(np.log2(acc_std * scale / 40.0))
    return x8.to(dev), w8.to(dev), bias.to(dev), scale, out_scale


def k2_bound(x8, w8, out):
    """K2's bound for one call: x, weights and bias read once, the output
    written once; 2 int8 operations per multiply-add."""
    n, ho, wo, co = out.shape
    k, ci = w8.shape[1], w8.shape[3]
    n_bytes = (x8.numel() + w8.numel() + 4 * co
               + out.numel() * out.element_size())
    return bound_ms(n_bytes, 2.0 * n * ho * wo * co * k * k * ci,
                    INT8_OPS_PER_S)


def int_mm_ms(x8, w8):
    """``torch._int_mm`` of the 1x1 conv's (N*H*W, Cin) x (Cin, Cout)
    product, the library yardstick (the port never calls it), or None where
    this PyTorch build refuses the shape."""
    a = x8.reshape(-1, x8.shape[-1])
    b = w8.reshape(w8.shape[0], -1).t()
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        print(f'  torch._int_mm refused the shape: {e}')
        return None
    return cuda_ms(lambda: torch._int_mm(a, b))


def phase_conv_kernel(dev):
    print('[5/6] K2 conv_int8 vs plain version')
    from yolo_tpu_torch.ops.conv_int8 import (fused_conv_int8,
                                              fused_conv_int8_reference)
    max_err = 0.0
    for case in K2_CASES:
        n, h, w, ci, co, k, s, act, out_q, maxabs = case
        x8, w8, bias, sc, osc = k2_inputs(case, dev)
        kw = dict(stride=s, act=act, out_q=out_q, maxabs=maxabs)
        got = fused_conv_int8(x8, w8, bias, sc, osc, **kw)
        torch.cuda.synchronize()
        want = fused_conv_int8_reference(x8, w8, bias, sc, osc, **kw)
        name = (f'{n}x{h}x{w} {ci}->{co} {k}x{k} s{s} {act}'
                f'{" maxabs" if maxabs else ""} {"int8" if out_q else "f32"}')
        check(got.shape == want.shape and got.dtype == want.dtype,
              f'{name}: shape {tuple(got.shape)} {got.dtype}')
        d = (got.double() - want.double()).abs()
        err = float(d.max())
        max_err = max(max_err, err)
        if act != 'mish':
            check(torch.equal(got, want), f'{name}: bit-equal')
        elif out_q:
            share = float((d > 0).double().mean())
            check(err <= 1, f'{name}: at most 1 LSB apart ({share:.2e} of '
                  f'the values differ)')
        else:
            rel = float((d / want.double().abs().clamp_min(1e-30)).max())
            check(bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5)),
                  f'{name}: within rtol/atol 1e-5 (max rel err {rel:.2e})')
    timed = []
    for case in K2_TIMED:
        n, h, w, ci, co, k, s = case
        x8, w8, bias, sc, osc = k2_inputs(case, dev)
        kw = dict(stride=s, act='leaky')
        out = fused_conv_int8(x8, w8, bias, sc, osc, **kw)
        ms = cuda_ms(lambda: fused_conv_int8(x8, w8, bias, sc, osc, **kw))
        plain = cuda_ms(lambda: fused_conv_int8_reference(x8, w8, bias, sc,
                                                          osc, **kw), iters=5)
        lib = int_mm_ms(x8, w8) if k == 1 else None
        b_ms, b_by = k2_bound(x8, w8, out)
        ops = 2.0 * out.numel() * k * k * ci
        print(f'  {k}x{k} s{s} {h} px {ci}->{co} bs={n}: kernel {ms:.4f} ms '
              f'({ops / ms / 1e9:.1f} TOP/s), plain {plain:.4f} ms, bound '
              f'{b_ms:.5f} ms by {b_by}'
              + (f', torch._int_mm {lib:.4f} ms' if lib is not None else ''))
        timed.append((case, ms, plain, b_ms, lib))
    return max_err, timed


def int8_bundle(dev, bs, size):
    """yolov3 at full width, random weights from a seed, zero BN running
    statistics, calibrated by CALIB_STEPS steps on ``dev``."""
    from yolo_tpu_torch import runtime
    b = runtime.load_model(CFG, device=dev, quantized=1, steps=100,
                           conv_scale=CONV_SCALE_Q,
                           generator=torch.Generator().manual_seed(0))
    b.state = {k: {f: torch.zeros_like(t) for f, t in d.items()}
               for k, d in b.state.items()}
    x = runtime.preprocess(images(3, bs, size), device=dev)
    t0 = time.perf_counter()
    for _ in range(CALIB_STEPS):
        b.apply(x, train=True)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    print(f'  calibrated: {CALIB_STEPS} steps at bs={bs} {size} px in '
          f'{time.perf_counter() - t0:.2f} s')
    return b, x


def int8_checks(b, x):
    """The main-path run with zeroed counts, then the engine through the
    plain conv and the f32 sim on the same batch. Returns the launches of
    that run and the engine's pieces for timing."""
    from yolo_tpu_torch.compress.quant import make_quant_apply
    from yolo_tpu_torch.models.int8_engine import make_int8_apply, prepare_int8
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.ops.conv_int8 import (fused_conv_int8,
                                              fused_conv_int8_reference)
    from yolo_tpu_torch.ops.nms_suppress import suppress
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    infer = b.make_infer(**kw)
    suppress.launches = fused_conv_int8.launches = 0
    dets = infer(x)
    sync()
    launches = {'nms_suppress': suppress.launches,
                'conv_int8': fused_conv_int8.launches}
    bs = x.shape[0]
    check(tuple(dets.shape) == (bs, 300, 6) and bool(torch.isfinite(dets).all()),
          'int8 detections (bs, max_det, 6), all finite')
    n_eng = int((dets[..., 4] > 0).sum())
    check(n_eng > 0, f'int8 engine: {n_eng} detections over the batch')

    plan = prepare_int8(b.net, b.params, b.state, b.qstate, b.qcfg)
    eng = make_int8_apply(b.net, plan, heads_only=True)
    anchors = b.anchors()
    with torch.inference_mode():
        heads, objs = eng(plan.arrays, x)
        box_xywh, obj, cls = nms._heads_candidates(
            heads, anchors, b.strides, b.nc + 5, CONF_THRES, 512, objs=objs,
            head_scales=eng.head_scales)
        valid = nms._pairs(box_xywh, obj, cls, CONF_THRES, 512, True,
                           False)[4]
        n_valid = int(valid.sum())
        check(n_valid > 0, f'{n_valid} valid candidates reach K1 '
              f'({valid.shape[1]} slots per image)')
        plain_heads = make_int8_apply(b.net, plan, heads_only=True,
                                      conv=fused_conv_int8_reference)(
            plan.arrays, x)[0]
        sync()
        for i, (a, c) in enumerate(zip(heads, plain_heads)):
            check(a.dtype == torch.int8 and torch.equal(a, c),
                  f'head {i}: engine through K2 == through its plain version '
                  f'({tuple(a.shape)} int8, bit-equal)')
        sim_heads = make_quant_apply(b.net, b.qcfg, heads_only=True)(
            b.params, b.state, b.qstate, x)[0]
        for i, (a, h, s) in enumerate(zip(heads, sim_heads,
                                          eng.head_scales)):
            dq = (a.to(torch.float32) - torch.round(h / s)).abs()
            print(f'  head {i} engine vs f32 sim: {float((dq > 0).double().mean()):.4f} '
                  f'of the values differ, by at most {float(dq.max()):.0f} quanta')
        kw_s = {**kw, 'conf_thres': SURVIVOR_CONF}
        d_eng = b.make_infer(**kw_s)(x)
        d_sim = b.make_infer(engine=False, **kw_s)(x)
        sync()
    n_eng = int((d_eng[..., 4] > 0).sum())
    n_sim = int((d_sim[..., 4] > 0).sum())
    check(abs(n_sim - n_eng) <= max(2, int(SURVIVOR_TOL * n_sim)),
          f'survivors at conf {SURVIVOR_CONF}: engine {n_eng}, f32 sim '
          f'{n_sim} (within max(2, {SURVIVOR_TOL:.0%}); '
          f'{x.shape[0] * kw["max_det"]} slots)')
    return launches, plan, infer


def int8_layer_times(b, plan, x):
    """Every K2 call of one engine batch, timed alone on its own inputs
    beside its plain version; the sums, the summed bound and the slowest
    layers against their bounds."""
    from yolo_tpu_torch.models.int8_engine import make_int8_apply
    from yolo_tpu_torch.ops.conv_int8 import (fused_conv_int8,
                                              fused_conv_int8_reference)
    calls = []

    def record(*args, **kw):
        out = fused_conv_int8(*args, **kw)
        calls.append((args, kw, out))
        return out

    with torch.inference_mode():
        make_int8_apply(b.net, plan, heads_only=True, conv=record)(
            plan.arrays, x)
    rows = []
    for args, kw, out in calls:
        x8, w8 = args[0], args[1]
        ms = cuda_ms(lambda: fused_conv_int8(*args, **kw), iters=10, warmup=2)
        plain = cuda_ms(lambda: fused_conv_int8_reference(*args, **kw),
                        iters=3, warmup=1)
        b_ms, b_by = k2_bound(x8, w8, out)
        ops = 2.0 * out.numel() * w8.shape[1] ** 2 * w8.shape[3]
        rows.append(dict(ms=ms, plain=plain, bound=b_ms, by=b_by, ops=ops,
                         what=f'{w8.shape[1]}x{w8.shape[1]} s{kw["stride"]} '
                              f'{x8.shape[1]}x{x8.shape[2]} '
                              f'{x8.shape[3]}->{w8.shape[0]}'))
    tot = {f: sum(r[f] for r in rows) for f in ('ms', 'plain', 'bound', 'ops')}
    by_ops = sum(r['bound'] for r in rows if r['by'] == 'operations')
    tot['by'] = 'operations' if by_ops >= tot['bound'] / 2 else 'bytes'
    print(f'  {len(rows)} K2 calls per batch of {x.shape[0]}: kernel '
          f'{tot["ms"]:.3f} ms in all ({tot["ops"] / tot["ms"] / 1e9:.1f} '
          f'TOP/s), plain {tot["plain"]:.3f} ms, bound {tot["bound"]:.4f} ms '
          f'({tot["ops"] / 1e12:.3f} T int8 operations; {by_ops:.4f} ms of '
          f'the bound from layers bound by operations)')
    for r in sorted(rows, key=lambda r: -r['ms'])[:6]:
        print(f'    {r["what"]}: {r["ms"]:.4f} ms, bound {r["bound"]:.5f} ms '
              f'by {r["by"]}, plain {r["plain"]:.3f} ms')
    return tot


# device-time groups of a profiled run, by kernel name
PROFILE_GROUPS = (('K2 conv_int8', ('conv_int8',)),
                  ('K1 nms_suppress', ('nms_suppress',)),
                  ('cuDNN/cuBLAS conv, gemm', ('conv', 'cudnn', 'xmma', 'gemm',
                                               'sm90')),
                  ('sort', ('sort', 'radix')),
                  ('elementwise', ('elementwise', 'vectorized', 'unrolled',
                                   'launch_clamp', 'where')),
                  ('cat, gather, index', ('cat', 'gather', 'index', 'copy')),
                  ('reduce', ('reduce',)))


def profile_device(fn, n=3):
    """Device time per call of ``fn`` by kernel group, busy share and kernel
    count, from torch.profiler over ``n`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    groups, n_kernels = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        n_kernels += e.count
        name = e.key.lower()
        g = next((g for g, keys in PROFILE_GROUPS
                  if any(k in name for k in keys)), 'other')
        groups[g] = groups.get(g, 0.0) + us / 1e3 / n
    busy = sum(groups.values())
    if busy == 0:
        print('  profiler: no device time recorded (not measured)')
        return
    print(f'  profile: {wall_ms:.3f} ms wall per batch, device busy '
          f'{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), '
          f'{n_kernels / n:.0f} kernels per batch')
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'    {g}: {ms:.3f} ms')


def phase_int8(dev, card):
    print('[6/6] yolov3 @608 int8 serving')
    from yolo_tpu_torch import runtime
    b, x = int8_bundle(dev, BS, SIZE)
    launches, plan, infer = int8_checks(b, x)
    n_conv = sum(l.kind == 'conv' for l in b.net.layers)
    check(launches['conv_int8'] == n_conv - 1,
          f'main path launched K2 {launches["conv_int8"]} times for one batch '
          f'({n_conv} convs less the float stem)')
    check(launches['nms_suppress'] == 1,
          f'main path launched K1 {launches["nms_suppress"]} time(s)')
    totals = int8_layer_times(b, plan, x)

    f16 = runtime.ModelBundle(net=b.net, params=b.params, state=b.state,
                              device=b.device).fuse()
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    finfer = f16.make_infer(**kw)
    runs = {'bf16': [], 'int8': []}
    for name in ('bf16', 'int8', 'int8', 'bf16'):
        fn = finfer if name == 'bf16' else infer
        runs[name].append(cuda_ms(lambda: fn(x), iters=10))
    for name in ('int8', 'bf16'):
        ms = statistics.median(runs[name])
        print(f'  {name} pipeline: {ms:.3f} ms per batch of {BS} (runs '
              f'{", ".join(f"{r:.3f}" for r in runs[name])}), '
              f'{BS * 1000.0 / ms:.1f} images/s ({card})')
    profile_device(lambda: infer(x))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    infer(x)
    torch.cuda.synchronize()
    print(f'  int8 pipeline peak device memory: '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB')
    return launches, totals


def check_imports():
    bad = sorted(m for m in sys.modules if m in ('jax', 'cv2')
                 or m == 'yolo_tpu' or m.startswith(('jax.', 'yolo_tpu.')))
    check(not bad, f'no jax, OpenCV or yolo_tpu module imported {bad or ""}')


def main():
    card = phase_device()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, 'yolo_tpu_torch')):
        raise SmokeFailure('yolo_tpu_torch/ not found beside chip_smoke.py')
    t0 = time.perf_counter()
    build_s = phase_build()
    k1 = phase_kernel(dev)
    k1_float = phase_pipeline(dev, card)
    k2_err, k2_timed = phase_conv_kernel(dev)
    launches, k2_tot = phase_int8(dev, card)
    check_imports()
    print(f'build {build_s:.2f} s; whole run {time.perf_counter() - t0:.1f} s')
    print(card)
    print(json.dumps({'kernels': [
        {'name': 'nms_suppress', 'route': 'cuda',
         'source': 'yolo_tpu_torch/csrc/nms_suppress.cu',
         'replaces': 'yolo_tpu/ops/pallas_nms.py:33',
         'launches': k1_float + launches['nms_suppress'], **k1},
        {'name': 'conv_int8', 'route': 'cuda',
         'source': 'yolo_tpu_torch/csrc/conv_int8.cu',
         'replaces': 'yolo_tpu/ops/pallas_conv.py:132',
         'launches': launches['conv_int8'], 'max_abs_err': k2_err,
         'ms': k2_tot['ms'], 'plain_ms': k2_tot['plain'],
         'bound_ms': k2_tot['bound'], 'bound_by': k2_tot['by'],
         'library_ms': None}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'FAILED: {e}', file=sys.stderr)
        sys.exit(1)
