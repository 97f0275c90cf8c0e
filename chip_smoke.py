#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``yolo_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and nothing runs on the CPU instead:

1. device: needs CUDA; prints the card's name and power limit (nvidia-smi).
   TF32 is turned off for matmuls and cuDNN convs, so every f32 comparison
   below is a true f32 comparison.
2. build: compiles ``yolo_tpu_torch/csrc/*.cu`` from the checkout into
   ``yolo_tpu_torch/_build/`` and prints the seconds it took.
3. kernel: the NMS suppression kernel against its plain PyTorch version on
   the card: bs=8 heavy-overlap candidates at k = 512, 300, 256 with and
   without merge, plus an all-invalid batch. ``keep`` must be bit-equal and
   the merged boxes within rtol 1e-5 / atol 1e-4 where kept. Prints the
   median CUDA-event times of both at k=512, bs=8.
4. pipeline: ``cfg/yolov3/yolov3.cfg`` at full width, 608x608, random
   weights from a seed, through ``load_model(device='cuda').fuse()
   .make_infer()``, bf16, channels_last, bs=8, dense and sparse decode, at
   the eval threshold conf 0.001 so that the candidate buffer fills. The
   kernel's launch count is zeroed just before that run and must have risen
   after it. Then, on the same heads, kernel NMS and plain NMS must agree
   (rtol 1e-5 / atol 1e-4), and at bs=1 the card's f32 heads must match the
   CPU's f32 heads (rtol 1e-3 / atol 1e-3: f32 convs summed in other orders
   over 75 layers), and the bf16 heads the card's f32 heads within 10% of
   the head's largest magnitude. Prints images/s of both decodes, timed in
   turns, and the time of the forward and of decode + NMS alone.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is the JSON device record.

No jax is imported: the port shares with the JAX package only its jax-free
cfg parser and checkpoint reader (``yolo_tpu/ir.py``, ``config.py``,
``utils/checkpoint.py``).
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
    print('[1/4] device')
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
    print('[2/4] build')
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
    print('[3/4] kernel vs plain version')
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
    print(f'  k=512 bs={BS} merge: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
    return max_err, ms, plain_ms


def phase_pipeline(dev, card):
    print('[4/4] yolov3 @608 pipeline')
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


def main():
    card = phase_device()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, 'yolo_tpu_torch')):
        raise SmokeFailure('yolo_tpu_torch/ not found beside chip_smoke.py')
    build_s = phase_build()
    max_err, ms, plain_ms = phase_kernel(dev)
    launches = phase_pipeline(dev, card)
    print(f'build {build_s:.2f} s')
    print(card)
    print(json.dumps({'kernels': [{
        'name': 'nms_suppress', 'route': 'cuda',
        'source': 'yolo_tpu_torch/csrc/nms_suppress.cu',
        'replaces': 'yolo_tpu/ops/pallas_nms.py:33',
        'launches': launches, 'max_abs_err': max_err,
        'ms': ms, 'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as e:
        print(f'FAILED: {e}', file=sys.stderr)
        sys.exit(1)
