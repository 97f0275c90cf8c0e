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
   the seconds it took and what ptxas reported for each conv_int8
   instantiation (registers, spills). Fails unless the conv_int8 kernels'
   SASS (``cuobjdump -sass``) holds the integer warpgroup MMA (IGMMA) and
   no IDP4A: K2 runs on the tensor cores.
3. K1: the NMS suppression kernel (one thread-block cluster per image)
   against its plain PyTorch version on the card (``K1_CASES``):
   heavy-overlap candidates at every k from 1 to 1024 that the plan treats
   differently, with and without merge, bs 1, 8 and 64 (more clusters than
   the card holds at once), a chain of 40 boxes capped at 0, 1, 3 and 16
   sweeps, IoU == thres, and an all-invalid batch. ``keep`` must be
   bit-equal and the merged boxes within rtol 1e-5 / atol 1e-4 where kept.
   At k=512, bs=8: the plan's cluster, the times of both, the wrapper's
   host time per call, the bound, and the device time at cluster sizes 4,
   8 and 16 (each held to the plain version too).
4. float pipeline: ``cfg/yolov3/yolov3.cfg`` at full width, 608x608, random
   weights from a seed, through ``load_model(device='cuda').fuse()
   .make_infer()``, bf16, channels_last, bs=8, dense and sparse decode, at
   the eval threshold conf 0.001 so that the candidate buffer fills. K1's
   launch count is zeroed just before that run and must have risen after
   it. Then, on the same heads, kernel NMS and plain NMS must agree
   (rtol 1e-5 / atol 1e-4), and at bs=1 the card's f32 heads must match the
   CPU's f32 heads (rtol 1e-3 / atol 1e-3: f32 convs summed in other orders
   over 75 layers), and the bf16 heads the card's f32 heads within 10% of
   the head's largest magnitude. Times K1 on the dense path's own
   candidates. Prints images/s of both decodes, timed in turns, the time
   of the forward and of decode + NMS alone, and a profile of the dense
   batch (device time by kernel group).
5. K2: the fused int8 conv kernel against its plain PyTorch version on the
   card: 1x1 s1, 3x3 s1 and s2, odd H/W, Cin not a multiple of 4 with Cout
   255, int8 and f32 outputs, leaky / linear / relu / mish / leaky under
   maxabsscaler, and the tile edges (Cin 32 at 304 px, Cin 1024 into Cout
   255, K*K*Cin = 4608, stride 2 on odd sizes). Outputs must be bit-equal,
   except with mish (the kernel's and PyTorch's tanh/exp may differ by an
   ulp): there at most 1 LSB apart, and the share that differs is printed.
   Prints the times of both, the bound, and ``torch._int_mm`` on the same
   product beside the 1x1 shape, at three yolov3 @608 bs=8 shapes.
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
   test allows); the head difference to the sim is printed in quanta.
   Then every K2 call of that batch is timed alone on its own inputs,
   beside its plain version and its bound, summed over the batch and over
   each class (3x3 s1, 3x3 s2, 1x1; time, bound, TOP/s), with
   ``torch._int_mm`` of the same products summed over the 1x1 calls as the
   library yardstick. The int8 pipeline is timed in turns with the bf16
   float pipeline on the same weights, and profiled (device time by kernel
   group). Prints the peak device memory.

7. mAP evaluation: ``eval.evaluator.evaluate`` through its ``loader=``
   argument (``MemoryLoader``: the ``BatchLoader`` tuple over 8 seeded
   batches of bs=8 in memory, no OpenCV), yolov3 @608, conf 0.001. Float
   (phase 4's model, bf16, fused, dense), then the f32 QAT sim and the
   int8 engine of phase 6's calibrated bundle, each against pseudo-labels
   made by the model itself (``pseudo_labels``: its detections above one
   confidence, at least 20 per image): the float model and the sim must
   score mAP@0.5 >= 0.99; the engine's mAP against the sim's labels is
   printed. Device and host matching must give equal results; the val
   losses (``LossHyp()``) must be finite; launch counts, zeroed before each
   evaluate, must read K1 once per batch and K2 74 times per engine batch.
   Prints the setup time of a first and a second call on one model (the
   cached Darknet; the cached int8 plan), evaluate's images/s against
   make_infer alone on the same batches (in turns), the host's queue-and-
   wait time and statistics pass, and a profile of each (the device's busy
   share shows whether the one-batch lookahead overlaps host and device).

8. more cfgs and paths (the phase's own seconds are printed):
   (a) ``cfg/yolov3-mobilenet/yolov3-mobilenet-visdrone.cfg`` (depthwise
   convs, SE blocks) at its 416 px and (b) ``cfg/yolov3/yolov3-asff.cfg``
   (ASFF heads) at 608 px, each at full width, random weights from a seed,
   bf16, fused, dense ``make_infer``, bs=8, conf 0.001: K1 launched once
   for the batch, detections, the card's f32 heads against the CPU's at
   bs=1 (rtol/atol 1e-3), images/s, the forward alone, a profile; (c)
   test-time augmentation of phase 4's yolov3 @608 (``make_infer(augment=
   True)``): K1 once per batch on the merged io of 22743 + 16128 + 12348
   rows per image, timed in turns against the single pass; (d) the int8
   engine of yolov3-mobilenet @416, bs=8, calibrated as in phase 6: K2 on
   every ungrouped conv on an int8 edge, the exact grouped int32 conv on
   the depthwise convs and the float-edge conv on the stem and after each
   SE block, each count checked after one batch; the heads through K2
   bit-equal to those through its plain version, the sim's survivors as
   in phase 6, every call of each route and every SE block timed alone,
   images/s against the bf16 float pipeline on the same weights, a
   profile; (e) (a)'s weights written by ``save_torch_checkpoint`` and
   served from the .pt give (a)'s detections bit for bit. Then one line
   says which image decoders (``cv2``, ``PIL``, ``torchvision.io``) import
   on the machine, each tried in a process of its own.

9. pruning (``compress/prune_drivers.py``, ``python -m yolo_tpu_torch.prune``),
   in a child process (``chip_smoke.py --phase9 DIR``: the file loader
   imports OpenCV, which this process must not), yolov3 @608 at full width,
   bs=8, random weights from seed 0 (``conv_scale`` 0.85) with half of each
   prunable layer's gammas set to U(1e-6, 1e-4) (``shrink_gammas``, the
   stand-in for a sparsity-trained model): (a) 64 seeded images written as
   JPEG files, read back and labelled with the model's own detections
   (``pseudo_labels``), an image list and a .data file; (b) the loader
   alone (``DetectionDataset`` + ``BatchLoader``, images/s, and
   ``cv2.imread`` alone), and ``evaluate`` from the files against
   ``evaluate`` from the same batches in memory, in turns (mAP@0.5 >= 0.99
   from the files); (c) ``channel_prune('normal', 0.5)``: host seconds,
   params and MACs, the compact model's f32 heads against the loose
   model's at bs=2 (rtol 1e-3, atol 1e-3 of the head's largest magnitude),
   mAP@0.5 before, loose and after, ``timed_forward`` before and after, and
   fused bf16 ``make_infer`` before and after in turns with a profile of
   each; (d) ``layer_prune(8)`` and ``eagle_eye_prune(normal, 0.5 +- 0.02,
   2 candidates, default_rng(0))`` with their evaluations (the best
   candidate kept); (e) ``python -m yolo_tpu_torch.prune --method normal``
   and ``--method layer`` on the .data file, side by side, each in a
   directory of its own: both exit 0, and their cfg and .weights, loaded
   back, give the in-process compact models' detections bit for bit. K1
   must launch once per batch of every evaluate there.

A kernel's time is taken twice, on the same inputs: ``cuda_ms``, what its
caller waits for (median CUDA-event time, the host's work to queue the
call included), and ``device_ms``, the device alone (a sleep kernel keeps
the card busy while the host queues the call). A pipeline's time is
``cuda_ms``.

The line before the last is a JSON object with each kernel's launches on
the main paths (phases 4, 6, 7, 8 and 9), error, times and bound (``ms``, ``plain_ms`` and
``library_ms`` by ``cuda_ms``, ``device_ms`` beside them; for nms_suppress
also its cluster and CTAs at k=512, bs=8, the wrapper's host time per call,
the device time by cluster size and both times on the dense path's own
candidates; for conv_int8 also its 1x1 times beside ``torch._int_mm``'s,
and its totals by class, and phase 8's engine by route);
the line before it the card's name and power limit; the last line is the JSON device record. At the end the
run checks that neither jax nor OpenCV nor any module of the JAX package
``yolo_tpu`` was imported into this process (phase 9's child loads
OpenCV).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# a sleep of about 0.5 ms at the H100's clock: longer than the host takes
# to queue one kernel call (see device_ms)
SLEEP_CYCLES = 1_000_000


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


def device_ms(fn, iters=20, warmup=3):
    """Median device time of one ``fn()`` call in milliseconds: a sleep
    kernel keeps the card busy while the host queues the two events and the
    call, so the host's launch overhead stays outside the interval (a
    kernel's own time; ``cuda_ms`` times what a caller waits for)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
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


def candidate_arrays(rng, bs, k, chain=0):
    """Score-sorted candidate sets with heavy overlap as numpy: boxes
    (bs, k, 4) f32, scores (bs, k) f32, valid (bs, k) bool. With ``chain``,
    min(chain, k) slots spread over the k hold a suppression chain instead:
    valid boxes 10 wide and 2 apart, far from the others, so that at
    iou_thres 0.6 each overlaps only the next (IoU 2/3; 3/7 with the one
    after) and the sweeps take about ``chain`` of them to converge."""
    cx, cy = rng.uniform(0, 200, (2, bs, k, 1))
    w, h = rng.uniform(5, 60, (2, bs, k, 1))
    boxes = np.concatenate([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    scores = np.sort(rng.uniform(0.05, 1.0, (bs, k)))[:, ::-1].copy()
    valid = scores > 0.1
    n = min(chain, k)
    if n:
        slots = np.linspace(0, k - 1, n).round().astype(int)
        x0 = 1000.0 + 2.0 * np.arange(n)
        y0 = np.full(n, 1000.0)
        boxes[:, slots] = np.stack([x0, y0, x0 + 10, y0 + 10], -1)
        valid[:, slots] = True
    return boxes.astype(np.float32), scores.astype(np.float32), valid


def candidates(rng, bs, k, dev, chain=0):
    """``candidate_arrays`` on ``dev`` with the invalid rows zeroed and the
    scores times valid, as ``_suppress_and_finalize`` hands them to K1."""
    boxes, scores, valid = candidate_arrays(rng, bs, k, chain)
    valid = torch.from_numpy(valid).to(dev)
    boxes = torch.where(valid[..., None], torch.from_numpy(boxes).to(dev), 0.0)
    scores = torch.from_numpy(scores).to(dev) * valid
    return boxes.contiguous(), scores.contiguous(), valid


def images(seed, bs, size):
    """uint8 NHWC images with smooth structure plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([np.sin(6 * xx), np.cos(5 * yy), np.sin(4 * (xx + yy))], -1)
    x = 127.5 + 80 * base[None] + rng.normal(0, 30, (bs, size, size, 3))
    return np.clip(x, 0, 255).astype(np.uint8)


def device_setup():
    """The card's name and power limit (nvidia-smi), with TF32 turned off
    for matmuls and cuDNN convs."""
    if not torch.cuda.is_available():
        raise SmokeFailure('no CUDA device: this smoke run needs the card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    print('[1/9] device')
    card = device_setup()
    print(f'  {torch.cuda.get_device_name(0)}; torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN')
    return card


def conv_sass(lib_path):
    """{opcode: count} of the matrix and dot-product instructions in the
    SASS of the conv_int8 kernels of the built library (cuobjdump)."""
    import re
    from torch.utils.cpp_extension import CUDA_HOME
    out = subprocess.run([os.path.join(CUDA_HOME or '/usr/local/cuda', 'bin',
                                       'cuobjdump'), '-sass', str(lib_path)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    ops, fn = {}, ''
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)',
                      line)
        if m and 'conv_int8' in fn and ('MMA' in m.group(1)
                                        or 'DP4A' in m.group(1)):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return ops


def phase_build():
    print('[2/9] build')
    import re
    from yolo_tpu_torch import _build
    lib = _build.library_path()
    if lib.exists():
        lib.unlink()                      # build from the sources every run
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f'  built {lib.relative_to(ROOT)} in {secs:.2f} s')
    # what ptxas said of each conv_int8 instantiation (BN, int8 or f32 out)
    fn = None
    for line in _build.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r'conv_int8_kernelILi(\d+)ELb([01])E', fn or '')
        if m and ('registers' in line or 'spill' in line):
            print(f'    BN={m.group(1)} {"int8" if m.group(2) == "1" else "f32"}'
                  f' out: {line.split(":", 1)[-1].strip()}')
        if 'conv_int8' in line and 'Performance Loss' in line:
            print(f'    {line.strip()}')
    ops = conv_sass(lib)
    igmma = sum(n for op, n in ops.items() if op.startswith('IGMMA'))
    check(igmma > 0 and not any('DP4A' in op for op in ops),
          f'conv_int8 runs on the tensor cores: {igmma} integer warpgroup '
          f'MMA (IGMMA) instructions in its SASS, no IDP4A ({ops})')
    return secs


# K1's cases: (bs, k, merge, chain length, max_sweeps). Every k the plan
# treats differently (one word, ragged words, one CTA, many CTAs, the
# largest k), bs=64 for more clusters than the card holds at once, and a
# chain of K1_CHAIN boxes capped below, near and past its length.
K1_KS = (1, 31, 32, 33, 65, 300, 512, 1000, 1024)
K1_CHAIN = 40
K1_SWEEPS = (0, 1, 3, 16)
K1_CASES = ([(BS, k, m, 0, 16) for k in K1_KS for m in (True, False)]
            + [(bs, k, True, 0, 16) for bs in (1, 64) for k in (512, 1000)]
            + [(bs, k, m, K1_CHAIN, s) for s in K1_SWEEPS
               for bs, k, m in ((BS, 512, True), (64, 1024, False))])
K1_CLUSTERS = (4, 8, 16)    # cluster sizes timed at k=512, bs=8


def host_us(fn, n=200):
    """The host's time per ``fn()`` call in microseconds: a host clock
    over ``n`` calls with no synchronise, divided by ``n``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / n * 1e6


def fixpoint_sweeps(oboxes, valid, iou_thres, cap=64):
    """The sweeps after which ``keep`` stops changing in every image (the
    plain version's fixpoint, at most ``cap``), and the overlapping pairs
    of valid candidates."""
    from yolo_tpu_torch.ops.boxes import box_iou_matrix
    k = valid.shape[1]
    over = box_iou_matrix(oboxes, oboxes) > torch.tensor(iou_thres)
    vv = valid[:, :, None] & valid[:, None, :]
    ar = torch.arange(k, device=valid.device)
    tri = over & (ar[:, None] < ar[None, :])
    keep, n = valid, 0
    while n < cap:
        new = valid & ~(tri & keep[:, :, None]).any(1)
        if torch.equal(new, keep):
            break
        keep, n = new, n + 1
    return n, int((over & vv).sum())


def k1_compare(got, ref, what):
    """``keep`` bit-equal, ``merged`` within KERNEL_TOL where kept; returns
    the largest merged error."""
    keep, merged = got
    keep_r, merged_r = ref
    m = keep[..., None]
    a, b = torch.where(m, merged, 0.0), torch.where(m, merged_r, 0.0)
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(torch.equal(keep, keep_r) and torch.allclose(a, b, **KERNEL_TOL),
          f'{what}: keep bit-equal ({int(keep.sum())} kept), merged within '
          f'tolerance (max abs err {err:.3g})')
    return err


def phase_kernel(dev):
    print('[3/9] K1 nms_suppress vs plain version')
    from yolo_tpu_torch.ops import nms_suppress as K1
    suppress, suppress_reference = K1.suppress, K1.suppress_reference
    rng = np.random.default_rng(0)
    max_err = 0.0
    for bs, k, merge, chain, sweeps in K1_CASES:
        boxes, scores, valid = candidates(rng, bs, k, dev, chain)
        kw = dict(iou_thres=0.6, merge=merge, max_sweeps=sweeps)
        got = suppress(boxes, boxes, scores, valid, **kw)
        torch.cuda.synchronize()
        ref = suppress_reference(boxes, boxes, scores, valid, **kw)
        max_err = max(max_err, k1_compare(
            got, ref, f'bs={bs} k={k} merge={merge} chain={chain} '
            f'max_sweeps={sweeps}: {int(valid.sum())} valid'))
    z = torch.zeros((BS, 512, 4), device=dev)
    keep, merged = suppress(z, z, torch.zeros((BS, 512), device=dev),
                            torch.zeros((BS, 512), dtype=torch.bool,
                                        device=dev), iou_thres=0.6)
    torch.cuda.synchronize()
    check(not bool(keep.any()) and bool(torch.isfinite(merged).all()),
          'all-invalid batch: nothing kept, merged finite')
    # iou exactly at the threshold (2 / 4 = 0.5) suppresses nothing; a
    # larger overlap suppresses the lower-scored box
    b = torch.tensor([[[0, 0, 4, 1], [0, 0, 2, 1], [10, 10, 14, 14],
                       [10, 10, 14, 13.5]]], dtype=torch.float32, device=dev)
    s = torch.tensor([[0.9, 0.8, 0.7, 0.6]], device=dev)
    v = torch.ones((1, 4), dtype=torch.bool, device=dev)
    keep = suppress(b, b, s, v, iou_thres=0.5)[0]
    keep_r = suppress_reference(b, b, s, v, iou_thres=0.5)[0]
    check(keep.tolist() == keep_r.tolist() == [[True, True, True, False]],
          'iou == thres keeps both boxes, bit-equal')

    boxes, scores, valid = candidates(rng, BS, 512, dev)
    kw = dict(iou_thres=0.6, merge=True)
    args = (boxes, boxes, scores, valid)
    plan = K1.device_plan(BS, 512, dev.index)
    print(f'  plan at k=512 bs={BS}: cluster {plan.cluster}, {plan.ctas} CTAs '
          f'of {K1.THREADS} threads, {plan.smem} bytes of shared memory each '
          f'(the card holds {K1.max_clusters(dev.index, 512)} clusters of '
          f'{K1.CLUSTER_MAX} at once)')
    ms = cuda_ms(lambda: suppress(*args, **kw))
    dev_ms = device_ms(lambda: suppress(*args, **kw))
    h_us = host_us(lambda: suppress(*args, **kw))
    plain_ms = cuda_ms(lambda: suppress_reference(*args, **kw))
    # each cluster size on the same inputs, held to the plain version too
    ref = suppress_reference(*args, **kw)
    by_cluster = {}
    for c in K1_CLUSTERS:
        out = (torch.empty_like(valid), torch.empty_like(boxes))
        launch = lambda: K1._launch(*args, *out, 0.6, 16, True, c)
        launch()
        torch.cuda.synchronize()
        k1_compare(out, ref, f'cluster {c}')
        by_cluster[c] = device_ms(launch)
    sweeps, n_pairs = fixpoint_sweeps(boxes, valid, 0.6)
    # the bound of these inputs: each input read once (class-offset and raw
    # boxes, scores, valid) and each output written once (keep, merged);
    # 14 f32 operations per IoU of a pair of valid candidates, 9 per
    # overlapping (i, j) of the merge and 4 divisions per valid row
    bs, k = valid.shape
    n_bytes = bs * k * (16 + 16 + 4 + 1) + bs * k * (1 + 16)
    nv = valid.sum(1).double()
    n_ops = float((nv * (nv - 1) / 2 * 14 + nv * 4).sum()) + 9 * n_pairs
    b_ms, b_by = bound_ms(n_bytes, n_ops, F32_OPS_PER_S)
    print(f'  k=512 bs={BS} merge: kernel {ms:.4f} ms (device alone '
          f'{dev_ms:.4f} ms, host {h_us:.1f} us per call), plain '
          f'{plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} '
          f'({n_bytes / 1e6:.3f} MB, {n_ops / 1e6:.2f} M f32 operations: '
          f'{int(nv.sum())} valid, {n_pairs} overlapping pairs, fixpoint '
          f'after {sweeps} sweeps)')
    print('  device alone by cluster size: ' + ', '.join(
        f'{c}: {t:.4f} ms' for c, t in by_cluster.items()))
    return dict(max_abs_err=max_err, ms=ms, device_ms=dev_ms, host_us=h_us,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, cluster=plan.cluster, ctas=plan.ctas,
                cluster_device_ms={str(c): t for c, t in by_cluster.items()})


def phase_pipeline(dev, card):
    print('[4/9] yolov3 @608 float pipeline')
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

        # K1 on the exact candidate set the dense path hands it: class-offset
        # boxes at conf 0.001, every one of the 512 slots filled
        boxes, oboxes, cand, _, valid = nms._candidates(
            io, CONF_THRES, kw['top_k'], True, False)
        zero = lambda t: torch.where(valid[..., None], t, 0.0).contiguous()
        args = (zero(oboxes), zero(boxes), (cand * valid).contiguous(),
                valid.contiguous())
        k1kw = dict(iou_thres=kw['iou_thres'])
        k1 = dict(ms=cuda_ms(lambda: suppress(*args, **k1kw)),
                  device_ms=device_ms(lambda: suppress(*args, **k1kw)),
                  valid=int(valid.sum()))
        k1['sweeps'], k1['pairs'] = fixpoint_sweeps(args[0], valid,
                                                    kw['iou_thres'])
        print(f'  K1 on the dense path\'s own candidates ({k1["valid"]} valid '
              f'of {valid.numel()} slots, {k1["pairs"]} overlapping pairs, '
              f'fixpoint after {k1["sweeps"]} sweeps): {k1["ms"]:.4f} ms, '
              f'device alone {k1["device_ms"]:.4f} ms')

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
    print('  dense bf16 batch, profiled:')
    profile_device(lambda: infer[False](x))
    return launches, k1


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
    # the tile edges of the tensor-core kernel: Cin 32 at 304 px, Cin 1024
    # into Cout 255, K*K*Cin = 4608, stride 2 on odd sizes
    (1, 304, 304, 32, 64, 3, 1, 'leaky', True, False),
    (2, 19, 19, 1024, 255, 1, 1, 'linear', True, False),
    (1, 19, 19, 512, 1024, 3, 1, 'leaky', True, False),
    (2, 37, 29, 64, 128, 3, 2, 'leaky', True, False),
    # yolov3-mobilenet @416 bs=8 (phase 8): Cin 72 and 40, padded to 80 and
    # 48, into Cout 24 and 120, which are not multiples of 16
    (8, 104, 104, 72, 24, 1, 1, 'linear', True, False),
    (8, 52, 52, 40, 120, 1, 1, 'relu6', True, False),
]
# yolov3 @608 bs=8 shapes: 3x3 s1 at 152 px, 3x3 s2 304 -> 152, 1x1 at 76 px
K2_TIMED = [(BS, 152, 152, 64, 128, 3, 1), (BS, 304, 304, 64, 128, 3, 2),
            (BS, 76, 76, 256, 128, 1, 1)]


def int8_conv_shapes(cfg=CFG, size=SIZE, bs=BS):
    """(N, H, W, Cin, Cout, K, stride) of every conv on an int8 edge of a
    square ``size`` input (every conv but the float stem), in network
    order, from the cfg alone."""
    from yolo_tpu_torch.ir import build_ir
    hw, out = {}, []
    for lyr in build_ir(cfg).layers:
        src = hw.get(lyr.index - 1, size)
        if lyr.kind == 'conv':
            hw[lyr.index] = (src + 2 * lyr.pad - lyr.size) // lyr.stride + 1
            out.append((bs, src, src, lyr.in_channels, lyr.filters, lyr.size,
                        lyr.stride))
        elif lyr.kind == 'upsample':
            hw[lyr.index] = src * lyr.stride
        elif lyr.kind == 'route':
            hw[lyr.index] = hw[lyr.layers[0]]
        elif lyr.kind == 'maxpool':
            hw[lyr.index] = (src + lyr.stride - 1) // lyr.stride
        else:
            hw[lyr.index] = src
    return out[1:]


def k2_class(k, stride):
    """K2's three classes of yolov3 convs: '3x3 s1', '3x3 s2', '1x1'."""
    return '1x1' if k == 1 else f'3x3 s{stride}'


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


def int_mm_ms(x8, w8, **timing):
    """(``cuda_ms``, ``device_ms``) of ``torch._int_mm`` on the 1x1 conv's
    (N*H*W, Cin) x (Cin, Cout) product, the library yardstick (the port
    never calls it), or None where this PyTorch build refuses the shape.
    Cout is padded to a multiple of 8 (255 -> 256), the width ``_int_mm``
    takes."""
    a = x8.reshape(-1, x8.shape[-1])
    b = w8.reshape(w8.shape[0], -1)
    b = torch.nn.functional.pad(b, (0, 0, 0, -b.shape[0] % 8)).t()
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        print(f'  torch._int_mm refused the shape: {e}')
        return None
    return (cuda_ms(lambda: torch._int_mm(a, b), **timing),
            device_ms(lambda: torch._int_mm(a, b), **timing))


def phase_conv_kernel(dev):
    print('[5/9] K2 conv_int8 vs plain version')
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
    for case in K2_TIMED:
        n, h, w, ci, co, k, s = case
        x8, w8, bias, sc, osc = k2_inputs(case, dev)
        kw = dict(stride=s, act='leaky')
        out = fused_conv_int8(x8, w8, bias, sc, osc, **kw)
        ms = cuda_ms(lambda: fused_conv_int8(x8, w8, bias, sc, osc, **kw))
        alone = device_ms(lambda: fused_conv_int8(x8, w8, bias, sc, osc,
                                                  **kw))
        plain = cuda_ms(lambda: fused_conv_int8_reference(x8, w8, bias, sc,
                                                          osc, **kw), iters=5)
        lib = int_mm_ms(x8, w8) if k == 1 else None
        b_ms, b_by = k2_bound(x8, w8, out)
        ops = 2.0 * out.numel() * k * k * ci
        print(f'  {k}x{k} s{s} {h} px {ci}->{co} bs={n}: kernel {ms:.4f} ms, '
              f'device alone {alone:.4f} ms ({ops / alone / 1e9:.1f} TOP/s), '
              f'plain {plain:.4f} ms, bound {b_ms:.5f} ms by {b_by}'
              + (f'; torch._int_mm {lib[0]:.4f} ms, device alone '
                 f'{lib[1]:.4f} ms' if lib is not None else ''))
    return max_err


def int8_bundle(dev, bs, size, cfg=CFG):
    """``cfg`` (yolov3) at full width, random weights from a seed, zero BN
    running statistics, calibrated by CALIB_STEPS steps on ``dev``."""
    from yolo_tpu_torch import runtime
    b = runtime.load_model(cfg, device=dev, quantized=1, steps=100,
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
    that run (and the calls of the engine's other two conv routes, the
    grouped int8 conv and the float-edge conv) and the engine's pieces for
    timing."""
    from yolo_tpu_torch.compress.quant import make_quant_apply
    from yolo_tpu_torch.models.int8_engine import make_int8_apply, prepare_int8
    from yolo_tpu_torch.ops import nms
    from yolo_tpu_torch.ops.conv_int8 import (float_edge_conv, fused_conv_int8,
                                              fused_conv_int8_reference,
                                              grouped_conv_int8)
    from yolo_tpu_torch.ops.nms_suppress import suppress
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    infer = b.make_infer(**kw)
    suppress.launches = fused_conv_int8.launches = 0
    grouped_conv_int8.calls = float_edge_conv.calls = 0
    dets = infer(x)
    sync()
    launches = {'nms_suppress': suppress.launches,
                'conv_int8': fused_conv_int8.launches,
                'grouped_conv_int8': grouped_conv_int8.calls,
                'float_edge_conv': float_edge_conv.calls}
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
    beside its plain version and its bound; the sums, overall and for each
    class (3x3 s1, 3x3 s2, 1x1), and the slowest layers against their
    bounds. On the 1x1 calls, ``torch._int_mm`` of the same (N*H*W, Cin) x
    (Cin, Cout) product is the library yardstick (the port never calls
    it)."""
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
        k = w8.shape[1]
        ms = cuda_ms(lambda: fused_conv_int8(*args, **kw), iters=10,
                     warmup=2)
        alone = device_ms(lambda: fused_conv_int8(*args, **kw), iters=10,
                          warmup=2)
        plain = cuda_ms(lambda: fused_conv_int8_reference(*args, **kw),
                        iters=3, warmup=1)
        lib = int_mm_ms(x8, w8, iters=10, warmup=2) if k == 1 else None
        b_ms, b_by = k2_bound(x8, w8, out)
        ops = 2.0 * out.numel() * k * k * w8.shape[3]
        rows.append(dict(ms=ms, dev=alone, plain=plain, bound=b_ms, by=b_by,
                         ops=ops, lib=lib, cls=k2_class(k, kw['stride']),
                         what=f'{k}x{k} s{kw["stride"]} '
                              f'{x8.shape[1]}x{x8.shape[2]} '
                              f'{x8.shape[3]}->{w8.shape[0]}'))
    tot = {f: sum(r[f] for r in rows)
           for f in ('ms', 'dev', 'plain', 'bound', 'ops')}
    by_ops = sum(r['bound'] for r in rows if r['by'] == 'operations')
    tot['by'] = 'operations' if by_ops >= tot['bound'] / 2 else 'bytes'
    print(f'  {len(rows)} K2 calls per batch of {x.shape[0]}: kernel '
          f'{tot["ms"]:.3f} ms in all, device alone {tot["dev"]:.3f} ms '
          f'({tot["ops"] / tot["dev"] / 1e9:.1f} TOP/s), plain '
          f'{tot["plain"]:.3f} ms, bound {tot["bound"]:.4f} ms '
          f'({tot["ops"] / 1e12:.3f} T int8 operations; {by_ops:.4f} ms of '
          f'the bound from layers bound by operations)')
    tot['classes'] = {}
    for cls in ('3x3 s1', '3x3 s2', '1x1'):
        rs = [r for r in rows if r['cls'] == cls]
        c = {f: sum(r[f] for r in rs) for f in ('ms', 'dev', 'bound', 'ops')}
        c['calls'] = len(rs)
        c['by_ops'] = sum(r['by'] == 'operations' for r in rs)
        tot['classes'][cls] = {'ms': c['ms'], 'device_ms': c['dev'],
                               'bound_ms': c['bound'], 'ops': c['ops'],
                               'calls': c['calls'], 'by_ops': c['by_ops']}
        print(f'    {cls}: {len(rs)} calls ({c["by_ops"]} bound by '
              f'operations), kernel {c["ms"]:.4f} ms, device alone '
              f'{c["dev"]:.4f} ms, bound {c["bound"]:.4f} ms, '
              f'{c["ops"] / c["dev"] / 1e9:.1f} TOP/s on the device '
              f'({c["ops"] / 1e12:.4f} T int8 operations)')
    ones = [r for r in rows if r['cls'] == '1x1']
    tot['ms_1x1'] = sum(r['ms'] for r in ones)
    tot['device_ms_1x1'] = sum(r['dev'] for r in ones)
    lib_ok = all(r['lib'] is not None for r in ones)
    tot['library_ms_1x1'] = (sum(r['lib'][0] for r in ones) if lib_ok
                             else None)
    tot['library_device_ms_1x1'] = (sum(r['lib'][1] for r in ones) if lib_ok
                                    else None)
    if lib_ok:
        print(f'    1x1: K2 {tot["ms_1x1"]:.4f} ms against torch._int_mm '
              f'{tot["library_ms_1x1"]:.4f} ms; device alone '
              f'{tot["device_ms_1x1"]:.4f} against '
              f'{tot["library_device_ms_1x1"]:.4f} ms, on the same '
              f'{len(ones)} products (s32 out, no epilogue; Cout 255 padded '
              'to 256)')
    for r in sorted(rows, key=lambda r: -r['dev'])[:6]:
        print(f'    {r["what"]}: {r["ms"]:.4f} ms, device alone '
              f'{r["dev"]:.4f} ms, bound {r["bound"]:.5f} ms by {r["by"]}, '
              f'plain {r["plain"]:.3f} ms')
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


def profile_device(fn, n=3, ranges=()):
    """Device time per call of ``fn`` by kernel group, busy share and kernel
    count, from torch.profiler over ``n`` calls after a warm-up; and the
    device time of the kernels launched inside each ``record_function``
    range named in ``ranges`` (see ``in_range``), a part of the groups."""
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
    def kernel_us(ev):          # kernels launched under ev, ev excluded
        return sum(c.self_device_time_total + kernel_us(c)
                   for c in ev.cpu_children)

    in_ranges = {r: [0.0, 0] for r in ranges}
    for e in prof.events():
        if e.name in ranges and e.device_type == torch.autograd.DeviceType.CPU:
            in_ranges[e.name][0] += kernel_us(e) / 1e3 / n
            in_ranges[e.name][1] += 1 / n
    groups, n_kernels = {}, 0
    for e in prof.key_averages():
        # a range's own span on the device timeline is no kernel
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key in ranges):
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
    for r, (ms, calls) in in_ranges.items():
        print(f'    of which {r}: {ms:.3f} ms in {calls:.0f} calls')
    return {'wall_ms': wall_ms, 'busy_ms': busy, 'kernels': n_kernels / n,
            'groups': groups, 'ranges': {r: v[0] for r, v in in_ranges.items()}}


class patched:
    """Within the block, each function ``module.name`` of ``targets``
    ({label: (module, name)}) is replaced by ``wrap(label, fn)``."""

    def __init__(self, targets, wrap):
        self.targets, self.wrap = targets, wrap

    def __enter__(self):
        self.saved = {label: getattr(mod, name)
                      for label, (mod, name) in self.targets.items()}
        for label, (mod, name) in self.targets.items():
            setattr(mod, name, self.wrap(label, self.saved[label]))
        return self

    def __exit__(self, *exc):
        for label, (mod, name) in self.targets.items():
            setattr(mod, name, self.saved[label])


def in_range(label, fn):
    """``fn`` inside a ``record_function(label)`` range, which
    ``profile_device(ranges=...)`` reads."""
    def call(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return call


def phase_int8(dev, card):
    print('[6/9] yolov3 @608 int8 serving')
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
    return launches, totals, b


# ------------------------------------------------------------ mAP evaluation

DATA = os.path.join(ROOT, 'data_cfg', 'coco2014.data')   # 80 classes, names
EVAL_IMAGES = 64          # 8 batches of BS
EVAL_LABELS = 20          # pseudo-labels per image: its top detections
# the pseudo-labels are the model's own top predictions (pseudo_labels), so
# the same model scores mAP@0.5 = 1 up to the AP interpolation's rounding;
# less means a fault in the loader, the matcher, the metrics or the NMS
EVAL_MAP_MIN = 0.99


class MemoryLoader:
    """The ``BatchLoader`` tuple (uint8 NHWC images, padded targets, valid,
    paths, shapes) over in-memory batches: no image files, no OpenCV."""

    def __init__(self, batches, labels, max_t):
        from yolo_tpu_torch.train.loss import pad_targets
        self.items = [(imgs, *pad_targets(lab, max_t),
                       [f'mem/{i}_{j}' for j in range(len(imgs))],
                       [None] * len(imgs))
                      for i, (imgs, lab) in enumerate(zip(batches, labels))]

    def __iter__(self):
        return iter(self.items)


def pseudo_labels(infer, batches, dev, n=EVAL_LABELS):
    """Per batch, per image: the model's own detections as [cls, x, y, w, h]
    labels normalised by the (square) image size, clipped to the image.

    Each image keeps every detection at or above one confidence for the
    whole set: the lowest of the images' ``n``-th highest confidences (so
    at least ``n`` per image). AP ranks predictions across images, so with
    a count per image instead, one image's unlabelled detection could
    outrank another's labelled one and count as a false positive before
    it; with one threshold every labelled prediction ranks above every
    other, and the model scores mAP@0.5 = 1 up to rounding. Two detections
    of one class that clip to the same box (boxes far larger than the
    image) give one label: only one prediction can claim it, the other is
    a false positive either way. Returns (labels, the threshold, the
    duplicates dropped)."""
    from yolo_tpu_torch.runtime import preprocess
    dets = [infer(preprocess(imgs, device=dev)).cpu().numpy()
            for imgs in batches]
    thres = min(d[d[:, 4] > 0][:n, 4].min() for db in dets for d in db)
    out, n_dup = [], 0
    for imgs, db in zip(batches, dets):
        size = imgs.shape[1]
        per = []
        for d in db:
            d = d[d[:, 4] >= thres]
            b = d[:, :4].clip(0, size)
            lab = np.column_stack([
                d[:, 5], (b[:, 0] + b[:, 2]) / 2 / size,
                (b[:, 1] + b[:, 3]) / 2 / size, (b[:, 2] - b[:, 0]) / size,
                (b[:, 3] - b[:, 1]) / size]).astype(np.float32)
            first = np.sort(np.unique(lab, axis=0, return_index=True)[1])
            n_dup += len(lab) - len(first)
            per.append(lab[first])
        out.append(per)
    return out, thres, n_dup


def memory_loader(batches, labels):
    """``MemoryLoader`` with a target capacity that holds every label."""
    return MemoryLoader(batches, labels,
                        max(sum(len(l) for l in per) for per in labels))


def timed_eval(net, params, state, loader, dev, data=DATA, **kw):
    """``evaluate`` on ``loader`` (None: the files that ``data`` names)
    with every launch count zeroed just before it; returns (its result,
    the launches of the run, wall s)."""
    from yolo_tpu_torch.eval.evaluator import evaluate
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    from yolo_tpu_torch.ops.nms_suppress import suppress
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    sync()
    suppress.launches = fused_conv_int8.launches = 0
    t0 = time.perf_counter()
    out = evaluate(net, params, state, data, batch_size=BS, img_size=SIZE,
                   loader=loader, device=dev, **kw)
    sync()
    wall = time.perf_counter() - t0
    return out, {'nms_suppress': suppress.launches,
                 'conv_int8': fused_conv_int8.launches}, wall


class EventWaits:
    """Times the host's waits on CUDA events inside the block (the
    evaluator waits on one event per batch). ``serial=True`` also makes
    the host wait on each event as soon as it is recorded, right after its
    batch is queued: the evaluator then queues no batch ahead, which is
    the run without the one-batch lookahead."""

    def __init__(self, serial=False):
        self.serial, self.secs = serial, 0.0

    def __enter__(self):
        ev = torch.cuda.Event
        self._orig = sync, record = ev.synchronize, ev.record

        def timed_sync(e):
            t0 = time.perf_counter()
            sync(e)
            self.secs += time.perf_counter() - t0

        def record_then_wait(e, stream=None):
            record(e, stream)
            if self.serial:
                timed_sync(e)
        ev.synchronize, ev.record = timed_sync, record_then_wait
        return self

    def __exit__(self, *exc):
        torch.cuda.Event.synchronize, torch.cuda.Event.record = self._orig


def lookahead_turns(run, n_images, card, what):
    """``run()`` (one evaluate) with the lookahead and serial, in turns:
    wall seconds and the host's seconds blocked on the batches' events."""
    out = {False: [], True: []}
    for serial in (False, True, True, False):
        with EventWaits(serial) as w:
            t0 = time.perf_counter()
            run()
            out[serial].append((time.perf_counter() - t0, w.secs))
    for serial, rs in out.items():
        name = 'serial (no lookahead)' if serial else 'lookahead'
        walls = [r[0] for r in rs]
        print(f'  {what} {name}: {n_images / statistics.median(walls):.1f} '
              f'images/s (runs {", ".join(f"{w:.4f}" for w in walls)} s; '
              f'host blocked on batch events '
              f'{", ".join(f"{r[1]:.4f}" for r in rs)} s; {card})')
    return out


def check_eval(res, launches, n_batches, what, k2_per_batch=0):
    """mAP@0.5 against the model's own pseudo-labels, finite val losses,
    K1 once per batch, K2 ``k2_per_batch`` times per batch."""
    (r, maps, _t) = res
    check(r[2] >= EVAL_MAP_MIN,
          f'{what}: mAP@0.5 {r[2]:.6f} >= {EVAL_MAP_MIN} against its own '
          f'pseudo-labels (P {r[0]:.4f}, R {r[1]:.4f}, F1 {r[3]:.4f})')
    check(all(np.isfinite(r[4:7])),
          f'{what}: val losses finite (box {r[4]:.4f}, obj {r[5]:.4f}, '
          f'cls {r[6]:.4f})')
    check(launches['nms_suppress'] == n_batches and
          launches['conv_int8'] == k2_per_batch * n_batches,
          f'{what}: K1 launched {launches["nms_suppress"]} times, K2 '
          f'{launches["conv_int8"]} times for {n_batches} batches')


def phase_eval(dev, card, qb, cfg=CFG, n_images=EVAL_IMAGES):
    """The evaluation path: ``evaluate`` on float yolov3 (device and host
    matching), the f32 QAT sim and the int8 engine of phase 6's calibrated
    bundle ``qb``, each against pseudo-labels made by the model itself."""
    print(f'[7/9] mAP evaluation: yolov3 @{SIZE}, {n_images} images, bs={BS}')
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.compress.quant import make_quant_apply
    from yolo_tpu_torch.eval.evaluator import evaluate, int8_engine_apply
    from yolo_tpu_torch.train.loss import LossHyp
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    n_batches = n_images // BS
    batches = [images(10 + i, BS, SIZE) for i in range(n_batches)]
    b16 = runtime.load_model(cfg, device=dev, conv_scale=CONV_SCALE,
                             generator=torch.Generator().manual_seed(0)).fuse()
    avecs = [np.asarray(l.anchors, np.float32) / l.yolo_stride
             for l in b16.net.layers if l.kind == 'yolo']
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    fkw = dict(fused=True, loss_hyp=LossHyp(), anchor_vecs=avecs, **kw)

    # setup of a first and a second call on the same model (no batch): the
    # second finds the eval-mode Darknet in the evaluator's cache
    setup = []
    for _ in range(2):
        t0 = time.perf_counter()
        evaluate(b16.net, b16.params, b16.state, DATA, loader=[], device=dev,
                 **fkw)
        sync()
        setup.append(time.perf_counter() - t0)
    print(f'  setup (no batch): first call {setup[0]:.4f} s, second '
          f'{setup[1]:.4f} s')

    infer = b16.make_infer(**kw)
    labels, thres, n_dup = pseudo_labels(infer, batches, dev)
    counts = [len(l) for per in labels for l in per]
    check(min(counts) >= EVAL_LABELS - n_dup,
          f'float: {sum(counts)} pseudo-labels, {min(counts)}-{max(counts)} '
          f'per image (confidence >= {thres:.6f}; {n_dup} duplicates '
          'dropped)')
    loader = memory_loader(batches, labels)
    res, launches, wall = timed_eval(b16.net, b16.params, b16.state, loader,
                                     dev, **fkw)
    check_eval(res, launches, n_batches, 'float bf16, device matching')
    res_h, _, wall_h = timed_eval(b16.net, b16.params, b16.state, loader, dev,
                                  device_match=False, **fkw)
    check(res_h[0] == res[0] and np.array_equal(res_h[1], res[1]),
          'device and host matching: the results tuple and maps equal')
    total = dict(launches)

    # evaluate against make_infer alone on the same batches (pre-uploaded),
    # in turns; the statistics pass is what evaluate's host spends outside
    # queueing and waiting (t_inf), less the cached setup
    xs = [runtime.preprocess(bt, device=dev) for bt in batches]

    def infer_all():
        for x in xs:
            infer(x)
        sync()
    runs = {'evaluate': [], 'make_infer': [], 'stats': [], 't_inf': []}
    for name in ('evaluate', 'make_infer', 'make_infer', 'evaluate'):
        if name == 'evaluate':
            (_, _, t), _, w = timed_eval(b16.net, b16.params, b16.state,
                                         loader, dev, **fkw)
            runs['stats'].append(w - t[0] - setup[1])
            runs['t_inf'].append(t[0])
        else:
            t0 = time.perf_counter()
            infer_all()
            w = time.perf_counter() - t0
        runs[name].append(w)
    for name in ('evaluate', 'make_infer'):
        print(f'  {name}: {n_images / statistics.median(runs[name]):.1f} '
              f'images/s (runs {", ".join(f"{w:.4f}" for w in runs[name])} '
              f's for {n_images} images; {card})')
    print(f'  evaluate: host wait and queue (t_inf) '
          f'{", ".join(f"{t:.4f}" for t in runs["t_inf"])} s; statistics '
          f'pass and printing {", ".join(f"{t:.4f}" for t in runs["stats"])}'
          f' s; host matching run {wall_h:.4f} s (device matching '
          f'{wall:.4f} s)')
    if dev.type == 'cuda':
        lookahead_turns(lambda: timed_eval(b16.net, b16.params, b16.state,
                                           loader, dev, **fkw),
                        n_images, card, 'float evaluate')
        print('  evaluate, profiled (overlap: device busy share of the wall):')
        profile_device(lambda: timed_eval(b16.net, b16.params, b16.state,
                                           loader, dev, **fkw), n=2)
        print('  make_infer alone on the same batches, profiled:')
        profile_device(infer_all, n=2)

    # the quantized bundle: pseudo-labels from its f32 sim; the sim and the
    # int8 engine evaluated against them
    qkw = dict(loss_hyp=LossHyp(), anchor_vecs=avecs, **kw)
    qlabels, qthres, n_dup = pseudo_labels(
        qb.make_infer(engine=False, **kw), batches, dev)
    counts = [len(l) for per in qlabels for l in per]
    check(min(counts) >= EVAL_LABELS - n_dup,
          f'sim: {sum(counts)} pseudo-labels, {min(counts)}-{max(counts)} '
          f'per image (confidence >= {qthres:.6f}; {n_dup} duplicates '
          'dropped)')
    qloader = memory_loader(batches, qlabels)
    sim = make_quant_apply(qb.net, qb.qcfg)
    res_s, ls, wall_s = timed_eval(qb.net, qb.params, qb.state, qloader, dev,
                                   quant_apply=sim, qstate=qb.qstate, **qkw)
    check_eval(res_s, ls, n_batches, 'f32 QAT sim')
    t_plan = []
    for _ in range(2):
        t0 = time.perf_counter()
        arrays, eng = int8_engine_apply(qb.net, qb.params, qb.state,
                                        qb.qstate, qb.qcfg, dev)
        sync()
        t_plan.append(time.perf_counter() - t0)
    print(f'  int8 engine setup (prepare_int8 plan): first call '
          f'{t_plan[0]:.4f} s, second {t_plan[1]:.4f} s')
    res_e, le, wall_e = timed_eval(qb.net, arrays, {}, qloader, dev,
                                   quant_apply=eng, **qkw)
    n_k2 = sum(l.kind == 'conv' for l in qb.net.layers) - 1
    r = res_e[0]
    check(le['nms_suppress'] == n_batches and
          le['conv_int8'] == n_k2 * n_batches and all(np.isfinite(r[4:7])),
          f'int8 engine: K1 launched {le["nms_suppress"]} times, K2 '
          f'{le["conv_int8"]} times ({n_k2} a batch) for {n_batches} '
          'batches; val losses finite')
    print(f'  int8 engine against the sim\'s pseudo-labels: mAP@0.5 '
          f'{r[2]:.6f} (P {r[0]:.4f}, R {r[1]:.4f}, F1 {r[3]:.4f}; losses '
          f'{r[4]:.4f} {r[5]:.4f} {r[6]:.4f}); sim {res_s[0][2]:.6f}')
    print(f'  sim {n_images / wall_s:.1f} images/s, int8 engine '
          f'{n_images / wall_e:.1f} images/s (one evaluate each; {card})')
    if dev.type == 'cuda':
        run_e = lambda: timed_eval(qb.net, arrays, {}, qloader, dev,
                                   quant_apply=eng, **qkw)
        lookahead_turns(run_e, n_images, card, 'int8 engine evaluate')
        print('  int8 engine evaluate, profiled:')
        profile_device(run_e, n=2)
    for k in total:
        total[k] += ls[k] + le[k]
    return total


# ------------- phase 8: depthwise, SE and ASFF cfgs, TTA, the mobilenet engine

MOBILE_CFG = os.path.join(ROOT, 'cfg', 'yolov3-mobilenet',
                          'yolov3-mobilenet-visdrone.cfg')
MOBILE_SIZE = 416
# yolov3-mobilenet's random float weights (f32 on the CPU, bs=1, seed 0):
# at 1.0 its heads have a std of 3.5-4.4 and confidences up to 0.995; at
# 0.9 they stay at the bias prior (confidence at most 0.05), at 1.1 they
# overflow
CONV_SCALE_MOBILE = 1.0
ASFF_CFG = os.path.join(ROOT, 'cfg', 'yolov3', 'yolov3-asff.cfg')
# as yolov3: at 0.6 no box passes conf 0.001, at 0.8 the confidences
# saturate (f32 on the CPU, bs=1, seed 0)
CONV_SCALE_ASFF = 0.7
# rows of test-time augmentation's merged io, yolov3 @608: the input, its
# flip scaled by 0.83 (504 px, padded to 512) and its 0.67 scale (407 px,
# padded to 448)
TTA_ROWS = 22743 + 16128 + 12348


def float_serving(dev, card, cfg, size, conv_scale, what):
    """A float cfg at full width through ``load_model(...).fuse()
    .make_infer()``, bf16, dense, bs=BS, conf 0.001: K1 once for the batch,
    detections, f32 heads on the card against the CPU's at bs=1, images/s,
    the forward alone and a profile. Returns (K1 launches, the unfused
    bundle, the batch, its detections)."""
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.ops.nms_suppress import suppress

    def bundle(device, dtype):
        return runtime.load_model(cfg, device=device, dtype=dtype,
                                  conv_scale=conv_scale,
                                  generator=torch.Generator().manual_seed(0))

    raw = bundle(dev, torch.bfloat16)
    b16 = raw.fuse()
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    infer = b16.make_infer(**kw)
    x = runtime.preprocess(images(21, BS, size), device=dev)
    infer(x)
    torch.cuda.synchronize()
    suppress.launches = 0
    dets = infer(x)
    torch.cuda.synchronize()
    launches = suppress.launches
    check(launches == 1, f'{what}: main path launched K1 {launches} time(s) '
          'for one batch')
    n = int((dets[..., 4] > 0).sum())
    check(tuple(dets.shape) == (BS, 300, 6)
          and bool(torch.isfinite(dets).all()) and n > 0,
          f'{what}: detections (bs, max_det, 6), all finite, {n} over the '
          'batch')
    x1 = runtime.preprocess(images(22, 1, size), device=dev)
    with torch.inference_mode():
        h_card = bundle(dev, torch.float32).fuse().model().forward_heads(x1)[0]
        h_cpu = bundle('cpu', torch.float32).fuse().model().forward_heads(
            x1.cpu())[0]
    for i, (a, c) in enumerate(zip(h_card, h_cpu)):
        err = float((a.cpu() - c).abs().max())
        check(torch.allclose(a.cpu(), c, **F32_HEADS_TOL),
              f'{what}: bs=1 f32 head {i} card vs CPU (max abs err '
              f'{err:.3g}, head max {float(c.abs().max()):.3g})')
    model = b16.model()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.forward_heads(x), iters=10)
    runs = [cuda_ms(lambda: infer(x), iters=10) for _ in range(2)]
    ms = statistics.median(runs)
    print(f'  {what}: {ms:.3f} ms per batch of {BS} (runs '
          f'{", ".join(f"{r:.3f}" for r in runs)}), {BS * 1000.0 / ms:.1f} '
          f'images/s bf16 dense ({card}); forward alone {fwd_ms:.3f} ms')
    profile_device(lambda: infer(x))
    return launches, raw, x, dets


def tta_serving(dev, card):
    """Test-time augmentation of yolov3 @608, bs=BS, bf16: K1 once per
    batch on the merged io of the three passes, timed in turns against the
    single pass. Returns the K1 launches of one batch."""
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.ops.nms_suppress import suppress
    b16 = runtime.load_model(CFG, device=dev, conv_scale=CONV_SCALE,
                             generator=torch.Generator().manual_seed(0)).fuse()
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    infer = {'tta': b16.make_infer(augment=True, **kw),
             'single': b16.make_infer(**kw)}
    x = runtime.preprocess(images(1, BS, SIZE), device=dev)
    with torch.inference_mode():
        rows = b16.model().forward_augment(x).shape[1]
    check(rows == TTA_ROWS, f'TTA: merged io of {rows} rows per image '
          '(22743 + 16128 + 12348)')
    infer['tta'](x)
    torch.cuda.synchronize()
    suppress.launches = 0
    dets = infer['tta'](x)
    torch.cuda.synchronize()
    launches = suppress.launches
    check(launches == 1, f'TTA: main path launched K1 {launches} time(s) for '
          'one batch')
    n = int((dets[..., 4] > 0).sum())
    check(tuple(dets.shape) == (BS, 300, 6)
          and bool(torch.isfinite(dets).all()) and n > 0,
          f'TTA: detections (bs, max_det, 6), all finite, {n} over the batch')
    runs = {'tta': [], 'single': []}
    for name in ('tta', 'single', 'single', 'tta'):
        runs[name].append(cuda_ms(lambda: infer[name](x), iters=10))
    for name, rs in runs.items():
        ms = statistics.median(rs)
        print(f'  yolov3 @{SIZE} {name}: {ms:.3f} ms per batch of {BS} (runs '
              f'{", ".join(f"{r:.3f}" for r in rs)}), {BS * 1000.0 / ms:.1f} '
              f'images/s bf16 dense ({card})')
    return launches


def engine_routes(net):
    """The expected conv routes of the int8 engine on ``net``: float edges
    (the stem and each conv right after an SE, avgpool or scale_channels
    layer), grouped convs (the exact int32 path), and K2 for the rest."""
    convs = [l for l in net.layers if l.kind in ('conv', 'depthwise')]
    n_float = sum(l.index == 0 or net.layers[l.index - 1].kind in (
        'se', 'avgpool', 'scale_channels') for l in convs)
    n_grouped = sum(l.groups > 1 for l in convs)
    return {'conv_int8': len(convs) - n_float - n_grouped,
            'grouped_conv_int8': n_grouped, 'float_edge_conv': n_float}


def engine_spans():
    """The int8 engine's routes besides K2, and its SE blocks: {label:
    (module, name)} of the functions it calls for them."""
    from yolo_tpu_torch.models import int8_engine as E
    from yolo_tpu_torch.ops import conv as C
    return {'grouped int8 conv': (E, 'grouped_conv_int8'),
            'float-edge conv': (E, 'float_edge_conv'),
            'SE block': (C, 'se_block_nhwc')}


def route_times(b, plan, x):
    """Every conv of one engine batch by its route (K2, the grouped int8
    conv, the float-edge conv) and every SE block, each call timed alone on
    its own inputs (device alone and by the caller's wait) and summed by
    route; K2's bound summed over its calls."""
    from yolo_tpu_torch.models import int8_engine as E
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    spans = engine_spans()
    calls = {'K2': [], **{label: [] for label in spans}}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls[name].append((fn, args, kw, out))
            return out
        return call

    with patched(spans, recorder), torch.inference_mode():
        E.make_int8_apply(b.net, plan, heads_only=True,
                          conv=recorder('K2', fused_conv_int8))(plan.arrays, x)
    out = {}
    for name, cs in calls.items():
        tot = {'calls': len(cs), 'ms': 0.0, 'device_ms': 0.0}
        for fn, args, kw, res in cs:
            run = lambda: fn(*args, **kw)
            with torch.inference_mode():
                tot['ms'] += cuda_ms(run, iters=10, warmup=2)
                tot['device_ms'] += device_ms(run, iters=10, warmup=2)
            if name == 'K2':
                tot['bound_ms'] = tot.get('bound_ms', 0.0) + k2_bound(
                    args[0], args[1], res)[0]
        out[name] = tot
        print(f'  {name}: {tot["calls"]} calls per batch of {x.shape[0]}, '
              f'{tot["device_ms"]:.4f} ms on the device, {tot["ms"]:.4f} ms '
              'by the caller\'s wait (each call alone, summed; in a call of '
              'many kernels the device timer counts the host\'s gaps between '
              'them)'
              + (f'; bound {tot["bound_ms"]:.4f} ms' if 'bound_ms' in tot
                 else ''))
    return out


def mobile_int8(dev, card):
    """The int8 engine of yolov3-mobilenet @416, bs=BS: calibration, the
    engine into the sparse NMS with every count zeroed before one batch,
    its heads through K2 against K2's plain twin, the sim's survivors, the
    routes' times, images/s and a profile. Returns the launches."""
    from yolo_tpu_torch import runtime
    b, x = int8_bundle(dev, BS, MOBILE_SIZE, cfg=MOBILE_CFG)
    launches, plan, infer = int8_checks(b, x)
    want = engine_routes(b.net)
    for name, n in want.items():
        check(launches[name] == n, f'mobilenet int8: {name} ran '
              f'{launches[name]} times for one batch ({n} expected)')
    check(launches['nms_suppress'] == 1, f'mobilenet int8: K1 launched '
          f'{launches["nms_suppress"]} time(s)')
    routes = route_times(b, plan, x)
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
        print(f'  mobilenet {name} pipeline: {ms:.3f} ms per batch of {BS} '
              f'(runs {", ".join(f"{r:.3f}" for r in runs[name])}), '
              f'{BS * 1000.0 / ms:.1f} images/s ({card})')
    spans = engine_spans()
    with patched(spans, in_range):
        prof = profile_device(lambda: infer(x), ranges=tuple(spans))
    return launches, routes, prof


def image_decoders():
    """Which image decoders import on this machine, each tried in a
    process of its own (importing one here would fail check_imports)."""
    found = {}
    for mod in ('cv2', 'PIL', 'torchvision.io'):
        r = subprocess.run([sys.executable, '-c', f'import {mod}'],
                           capture_output=True, timeout=300)
        found[mod] = r.returncode == 0
    print('  image decoders: ' + ', '.join(
        f'{m} {"imports" if ok else "does not import"}'
        for m, ok in found.items()))
    return found


def phase_new_cfgs(dev, card):
    """(a) yolov3-mobilenet @416 and (b) yolov3-asff @608 float serving,
    (c) TTA on yolov3 @608, (d) the yolov3-mobilenet int8 engine, (e)
    (a)'s weights through a .pt; then the image decoders. Returns the
    launches of K1 and K2 and the engine's routes."""
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.models.torch_import import save_torch_checkpoint
    t0 = time.perf_counter()
    print(f'[8/9] more cfgs: (a) yolov3-mobilenet @{MOBILE_SIZE}, (b) '
          f'yolov3-asff @{SIZE}, (c) TTA yolov3 @{SIZE}, (d) mobilenet int8, '
          '(e) .pt')
    k1 = 0
    n, raw, x, dets = float_serving(dev, card, MOBILE_CFG, MOBILE_SIZE,
                                    CONV_SCALE_MOBILE, '(a) mobilenet')
    k1 += n
    k1 += float_serving(dev, card, ASFF_CFG, SIZE, CONV_SCALE_ASFF,
                        '(b) asff')[0]
    k1 += tta_serving(dev, card)
    launches, routes, prof = mobile_int8(dev, card)
    routes['profile'] = prof
    k1 += launches['nms_suppress']
    path = os.path.join(ROOT, 'yolo_tpu_torch', '_build', 'phase8_mobile.pt')
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_torch_checkpoint(raw.net, raw.params, raw.state, path)
    try:
        b = runtime.load_model(MOBILE_CFG, path, device=dev).fuse()
    finally:
        os.remove(path)
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    got = b.make_infer(**kw)(x)
    check(torch.equal(got, dets), '(e) mobilenet through a .pt written by '
          'save_torch_checkpoint: the same detections, bit for bit')
    image_decoders()
    print(f'  phase 8: {time.perf_counter() - t0:.1f} s')
    return {'nms_suppress': k1, 'conv_int8': launches['conv_int8']}, routes



# ------------------------------------------------- phase 9: the pruning toolchain

PRUNE_IMAGES = 64         # 8 batches of BS, JPEG files on disk
JPEG_QUALITY = 95
# the stand-in for a sparsity-trained model: this share of each prunable
# layer's gammas goes to U(1e-6, 1e-4) (tests/test_prune.py::_shrink_gammas)
PRUNE_SHRINK = 0.5
# the shrunk channels carry no signal, so the random weights need a larger
# scale than phase 4's 0.7: with the shrink, 0.7 leaves every confidence
# below 0.001 (no pseudo-label at all, on the card); at 0.85 each image
# keeps 20 or more boxes above 0.9 (phase 9 (a) prints the threshold)
PRUNE_CONV_SCALE = 0.85
PRUNE_PERCENT = 0.5       # normal prune: the global gamma percentile
PRUNE_SHORTCUTS = 8       # layer prune: shortcut blocks removed
EAGLE = dict(method='normal', remain_ratio=0.5, delta=0.02, candidates=2)
# the compact model's f32 heads against the loose model's: rtol, and atol
# as a share of the largest head magnitude (the sliced convs sum fewer
# terms, the dead channels' constants arrive through the consumers' biases)
PRUNE_HEADS_TOL = 1e-3


def shrink_gammas(params, prune_idx, frac=PRUNE_SHRINK, seed=0):
    """``frac`` of each listed layer's gammas to U(1e-6, 1e-4), drawn as
    ``tests/test_prune.py::_shrink_gammas`` draws them; new tensors."""
    rng = np.random.RandomState(seed)
    out = {k: dict(v) for k, v in params.items()}
    for i in prune_idx:
        g = out[str(i)]['gamma']
        a = g.cpu().numpy().copy()
        n = max(int(len(a) * frac), 1)
        idx = rng.choice(len(a), n, replace=False)
        a[idx] = rng.uniform(1e-6, 1e-4, n)
        out[str(i)]['gamma'] = torch.from_numpy(a).to(g.device)
    return out


def write_jpeg_set(root, infer, dev, n_images):
    """``n_images`` seeded images as JPEG files under ``root/images``, read
    back (the pixels the loader sees) and labelled with ``infer``'s own
    detections (``pseudo_labels``) under ``root/labels``; an image list and
    a .data file (80 classes, the COCO names). Returns (the .data path, the
    batches read back, their labels)."""
    import cv2
    for d in ('images', 'labels'):
        os.makedirs(os.path.join(root, d))
    paths, batches = [], []
    for b in range(n_images // BS):
        back = []
        for j, im in enumerate(images(40 + b, BS, SIZE)):
            p = os.path.join(root, 'images', f'im{b}_{j}.jpg')
            cv2.imwrite(p, im[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY,
                                           JPEG_QUALITY])
            back.append(cv2.imread(p)[..., ::-1])       # BGR file -> RGB
            paths.append(p)
        batches.append(np.ascontiguousarray(np.stack(back)))
    labels, thres, n_dup = pseudo_labels(infer, batches, dev)
    flat = [lab for per in labels for lab in per]
    for p, lab in zip(paths, flat):
        np.savetxt(p.replace('images', 'labels').replace('.jpg', '.txt'),
                   lab, fmt='%d %.9f %.9f %.9f %.9f')
    with open(os.path.join(root, 'val.txt'), 'w') as f:
        f.write('\n'.join(paths) + '\n')
    data = os.path.join(root, 'set.data')
    with open(data, 'w') as f:
        f.write(f'classes=80\nvalid={root}/val.txt\n'
                f'names={ROOT}/data_cfg/coco.names\n')
    counts = [len(lab) for lab in flat]
    check(min(counts) >= EVAL_LABELS - n_dup,
          f'(a) {n_images} JPEG files, {sum(counts)} pseudo-labels, '
          f'{min(counts)}-{max(counts)} per image (confidence >= '
          f'{thres:.6f}; {n_dup} duplicates dropped)')
    return data, batches, labels


def time_loader(data, n_images, card):
    """(b) The data layer alone: decode of every file, ``DetectionDataset``
    set-up and one pass of ``BatchLoader``, twice; returns the loader's
    images/s of the second pass."""
    import cv2
    from yolo_tpu_torch.config import parse_data_cfg
    from yolo_tpu_torch.data.datasets import BatchLoader, DetectionDataset
    valid = parse_data_cfg(data)['valid']
    paths = open(valid).read().split()
    t0 = time.perf_counter()
    for p in paths:
        cv2.imread(p)
    decode = (time.perf_counter() - t0) / len(paths)
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        ds = DetectionDataset(valid, SIZE, BS, rect=True)
        t_ds = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(sum(bool(p) for p in b[3]) for b in BatchLoader(ds, BS))
        t_it = time.perf_counter() - t0
        check(n == n_images, f'(b) the loader gave {n} images')
        rates.append(n / t_it)
        print(f'  (b) loader: dataset set-up {t_ds:.4f} s, one pass '
              f'{t_it:.4f} s = {n / t_it:.1f} images/s ({1e3 * t_it / n:.3f}'
              f' ms an image; cv2.imread alone {1e3 * decode:.3f} ms an '
              f'image; host, beside {card})')
    return rates[-1]


def prune_evals(counter, dev):
    """``timed_eval`` from files with K1 checked once per batch; every
    run's launches are added to ``counter``."""
    def run(net, params, state, data, what, loader=None):
        res, launches, wall = timed_eval(net, params, state, loader, dev,
                                         data=data)
        n_batches = PRUNE_IMAGES // BS
        want = n_batches if dev.type == 'cuda' else 0   # the CPU runs the twin
        check(launches['nms_suppress'] == want,
              f'{what}: K1 launched {launches["nms_suppress"]} times for '
              f'{n_batches} batches')
        counter['nms_suppress'] += launches['nms_suppress']
        return res, wall
    return run


def heads_f32(net, params, state, x):
    from yolo_tpu_torch.runtime import ModelBundle
    m = ModelBundle(net=net, params=params, state=state, device=x.device,
                    dtype=torch.float32).model()
    with torch.inference_mode():
        return m.forward_heads(x)[0]


def serving_turns(bundles, x, card, what):
    """The fused bf16 ``make_infer`` of each bundle in turns (a b b a) by
    ``cuda_ms``, then a profile of each; returns {name: (ms, profile)}."""
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    infers = {n: b.fuse().make_infer(**kw) for n, b in bundles.items()}
    names = list(infers)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(cuda_ms(lambda: infers[n](x), iters=10))
    out = {}
    for n in names:
        ms = statistics.median(runs[n])
        print(f'  {what} {n}: {ms:.3f} ms per batch of {x.shape[0]} (runs '
              f'{", ".join(f"{r:.3f}" for r in runs[n])}), '
              f'{x.shape[0] * 1000.0 / ms:.1f} images/s bf16 dense ({card})')
        out[n] = (ms, profile_device(lambda: infers[n](x), n=2))
    return out


def run_cli(method, cfg, weights, data, workdir, dev):
    """Start ``python -m yolo_tpu_torch.prune --method ...`` in
    ``workdir``; returns (the process, its log path)."""
    os.makedirs(workdir)
    log = os.path.join(workdir, 'cli.log')
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, '-m', 'yolo_tpu_torch.prune', '--method', method,
           '--cfg', cfg, '--weights', weights, '--data', data, '--img-size',
           str(SIZE), '--batch-size', str(BS), '--device', str(dev)]
    with open(log, 'w') as f:
        return subprocess.Popen(cmd, cwd=workdir, env=env, stdout=f,
                                stderr=subprocess.STDOUT), log


def prune_child(root, dev):
    """Phase 9 (in a process of its own: the file loader imports OpenCV).
    Writes its numbers to ``root/phase9.json``."""
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.compress import prune as P
    from yolo_tpu_torch.compress.prune_cli import timed_forward
    from yolo_tpu_torch.compress.prune_drivers import (channel_prune,
                                                       eagle_eye_prune,
                                                       layer_prune)
    from yolo_tpu_torch.models.darknet_io import save_darknet_weights
    card = device_setup() if dev.type == 'cuda' else 'the CPU'
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    out = {'nms_suppress': 0}
    evaluate = prune_evals(out, dev)

    raw = runtime.load_model(CFG, device=dev, conv_scale=PRUNE_CONV_SCALE,
                             generator=torch.Generator().manual_seed(0))
    net = raw.net
    sets = P.prunable_sets_normal(net)
    params = shrink_gammas(raw.params, sets.prune_idx)
    state = raw.state
    base = runtime.ModelBundle(net=net, params=params, state=state,
                               device=dev)
    kw = dict(conf_thres=CONF_THRES, iou_thres=0.6, top_k=512, max_det=300)
    print(f'  {len(sets.prune_idx)} of {len(sets.cbl_idx)} conv+BN layers '
          f'prunable (normal); {PRUNE_SHRINK:.0%} of their gammas set to '
          'U(1e-6, 1e-4)')

    # (a) the labelled set on disk, labelled by the unfused bf16 model that
    # evaluate runs
    data, batches, labels = write_jpeg_set(os.path.join(root, 'set'),
                                           base.make_infer(**kw), dev,
                                           PRUNE_IMAGES)

    # (b) the loader alone, and evaluate from the files against evaluate
    # from the same batches in memory, in turns
    loader_rate = time_loader(data, PRUNE_IMAGES, card)
    mem = memory_loader(batches, labels)
    walls = {'files': [], 'memory': []}
    for name in ('files', 'memory', 'memory', 'files'):
        res, wall = evaluate(net, params, state, data, f'(b) {name}',
                             loader=mem if name == 'memory' else None)
        walls[name].append(wall)
        if name == 'files':
            before = res
    rates = {n: PRUNE_IMAGES / statistics.median(w) for n, w in walls.items()}
    for n, w in walls.items():
        print(f'  (b) evaluate from {n}: {rates[n]:.1f} images/s (runs '
              f'{", ".join(f"{v:.4f}" for v in w)} s; {card})')
    check(before[0][2] >= EVAL_MAP_MIN,
          f'(b) mAP@0.5 {before[0][2]:.6f} against its own pseudo-labels '
          'through the file loader')
    out.update(loader_images_per_s=loader_rate,
               evaluate_images_per_s=rates, map_before=before[0][2])

    # (c) normal channel prune
    sync()
    t0 = time.perf_counter()
    res = channel_prune(net, params, state, method='normal',
                        percent=PRUNE_PERCENT, img_size=SIZE)
    sync()
    t_prune = time.perf_counter() - t0
    r = res.report
    print(f'  (c) normal {PRUNE_PERCENT}: {t_prune:.3f} s on the host; '
          f'params {r["params_before"]} -> {r["params_after"]}, MACs '
          f'{r["macs_before"]} -> {r["macs_after"]} '
          f'({r["macs_after"] / r["macs_before"]:.4f}); threshold '
          f'{r["threshold"]:.3g}')
    x2 = runtime.preprocess(batches[0][:2], device=dev)
    for i, (c, l, o) in enumerate(zip(
            heads_f32(res.net, res.params, res.state, x2),
            heads_f32(net, res.loose_params, res.loose_state, x2),
            heads_f32(net, params, state, x2))):
        scale = float(l.abs().max())
        err = float((c - l).abs().max())
        check(torch.allclose(c, l, rtol=PRUNE_HEADS_TOL,
                             atol=PRUNE_HEADS_TOL * scale),
              f'(c) compact vs loose f32 head {i} at bs=2 (max abs err '
              f'{err:.3g}, head max {scale:.3g})')
        # what the shrunk channels still carried: gamma <= 1e-4 times the
        # normalised input, whose scale the random running statistics do
        # not bound (not gated)
        d = (l - o).abs()
        print(f'  (c) unpruned vs loose f32 head {i}: max abs diff '
              f'{float(d.max()):.3g}, mean {float(d.mean()):.3g} (head max '
              f'{float(o.abs().max()):.3g})')
    loose, _ = evaluate(net, res.loose_params, res.loose_state, data,
                        '(c) loose')
    after, _ = evaluate(res.net, res.params, res.state, data, '(c) compact')
    print(f'  (c) mAP@0.5 before {before[0][2]:.6f}, loose '
          f'{loose[0][2]:.6f}, after {after[0][2]:.6f}')
    t_fwd = [timed_forward(n, p, s, SIZE) * 1e3 for n, p, s in (
        (net, params, state), (res.net, res.params, res.state))]
    print(f'  (c) timed_forward (bs=16, bf16, BN unfused): before '
          f'{t_fwd[0]:.3f} ms, after {t_fwd[1]:.3f} ms ({card})')
    x = runtime.preprocess(batches[0], device=dev)
    compact = runtime.ModelBundle(net=res.net, params=res.params,
                                  state=res.state, device=dev)
    serving = (serving_turns({'before': base, 'after': compact}, x, card,
                             '(c) make_infer') if dev.type == 'cuda' else {})
    out.update(prune_s=t_prune, report=r, map_loose=loose[0][2],
               map_after=after[0][2], timed_forward_ms=t_fwd,
               serving={n: {'ms': v[0], 'profile': v[1]}
                        for n, v in serving.items()})

    # (d) layer prune and EagleEye
    sync()
    t0 = time.perf_counter()
    lres = layer_prune(net, params, state, n_shortcuts=PRUNE_SHORTCUTS,
                       img_size=SIZE)
    sync()
    t_layer = time.perf_counter() - t0
    lafter, t_leval = evaluate(lres.net, lres.params, lres.state, data,
                               '(d) layer')
    r = lres.report
    print(f'  (d) layer {PRUNE_SHORTCUTS} shortcuts: {t_layer:.3f} s; '
          f'{len(net.layers)} -> {len(lres.net.layers)} layers, MACs '
          f'{r["macs_after"] / r["macs_before"]:.4f}; mAP@0.5 '
          f'{lafter[0][2]:.6f} (evaluate {t_leval:.3f} s)')
    maps = []

    def eval_fn(cand):
        m = evaluate(cand.net, cand.params, cand.state, data,
                     '(d) EagleEye candidate')[0][0][2]
        maps.append(m)
        return m
    sync()
    t0 = time.perf_counter()
    eres = eagle_eye_prune(net, params, state, img_size=SIZE,
                           rng=np.random.default_rng(0), eval_fn=eval_fn,
                           **EAGLE)
    t_eagle = time.perf_counter() - t0
    check(len(maps) == EAGLE['candidates']
          and eres.report['best_map'] == max(maps),
          f'(d) EagleEye: {len(maps)} candidates, mAP@0.5 '
          f'{", ".join(f"{m:.6f}" for m in maps)}; kept the best, MACs '
          f'ratio {eres.report["macs_ratio"]:.4f}; {t_eagle:.3f} s with '
          'their evaluations')
    out.update(layer_s=t_layer, map_layer=lafter[0][2], eagle_s=t_eagle,
               eagle_maps=maps, eagle_ratio=eres.report['macs_ratio'])

    # (e) the CLI on the same weights, normal and layer side by side
    os.makedirs(os.path.join(root, 'cfg'))
    cfg = os.path.join(root, 'cfg', os.path.basename(CFG))
    shutil.copy(CFG, cfg)
    weights = os.path.join(root, 'model.weights')
    save_darknet_weights(net, params, state, weights)
    t0 = time.perf_counter()
    procs = {m: run_cli(m, cfg, weights, data, os.path.join(root, m), dev)
             for m in ('normal', 'layer')}
    try:
        for m, (proc, log) in procs.items():
            rc = proc.wait(timeout=600)
            text = open(log).read()
            table = [l for l in text.splitlines() if l.startswith((
                'Metric', 'mAP', 'Parameters', 'MACs', 'Inference'))]
            print('\n'.join(f'  (e) {m}: {l}' for l in table))
            check(rc == 0, f'(e) python -m yolo_tpu_torch.prune --method {m}'
                  f' exited {rc}' + ('' if rc == 0 else f':\n{text[-4000:]}'))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_cli = time.perf_counter() - t0
    tags = {'normal': f'normal_prune_{PRUNE_PERCENT}_',
            'layer': f'layer_prune_{PRUNE_SHORTCUTS}_shortcut_'}
    for m, r_in in (('normal', res), ('layer', lres)):
        b = runtime.load_model(
            os.path.join(root, 'cfg', tags[m] + os.path.basename(CFG)),
            os.path.join(root, m, 'weights', tags[m].rstrip('_') + '.weights'),
            device=dev).fuse()
        got = b.make_infer(**kw)(x)
        want = runtime.ModelBundle(net=r_in.net, params=r_in.params,
                                   state=r_in.state, device=dev
                                   ).fuse().make_infer(**kw)(x)
        check(torch.equal(got, want), f'(e) {m}: the CLI\'s cfg and .weights'
              ' give the in-process compact model\'s detections bit for bit'
              f' ({int((got[..., 4] > 0).sum())} over the batch)')
    out.update(cli_s=t_cli, seconds=time.perf_counter() - t_phase)
    print(f'  (e) both CLI runs {t_cli:.1f} s; phase 9 (child) '
          f'{out["seconds"]:.1f} s')
    with open(os.path.join(root, 'phase9.json'), 'w') as f:
        json.dump(out, f)


def phase_prune():
    """Phase 9 in a child process; returns its numbers."""
    print(f'[9/9] pruning: yolov3 @{SIZE}, {PRUNE_IMAGES} JPEG files, '
          f'bs={BS} (a child process)')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        sys.stdout.flush()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--phase9', root], timeout=900)
        if r.returncode != 0:
            raise SmokeFailure(f'phase 9 (child) exited {r.returncode}')
        with open(os.path.join(root, 'phase9.json')) as f:
            out = json.load(f)
    print(f'  phase 9: {time.perf_counter() - t0:.1f} s')
    return out


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
    k1_float, k1_main = phase_pipeline(dev, card)
    k2_err = phase_conv_kernel(dev)
    launches, k2_tot, qb = phase_int8(dev, card)
    eval_launches = phase_eval(dev, card, qb)
    new_launches, routes = phase_new_cfgs(dev, card)
    prune = phase_prune()
    check_imports()
    print(f'build {build_s:.2f} s; whole run {time.perf_counter() - t0:.1f} s')
    print(card)
    print(json.dumps({'kernels': [
        {'name': 'nms_suppress', 'route': 'cuda',
         'source': 'yolo_tpu_torch/csrc/nms_suppress.cu',
         'replaces': 'yolo_tpu/ops/pallas_nms.py:33',
         'launches': (k1_float + launches['nms_suppress']
                      + eval_launches['nms_suppress']
                      + new_launches['nms_suppress']
                      + prune['nms_suppress']), **k1,
         'launches_phase9': prune['nms_suppress'],
         'main_path_ms': k1_main['ms'],
         'main_path_device_ms': k1_main['device_ms']},
        {'name': 'conv_int8', 'route': 'cuda',
         'source': 'yolo_tpu_torch/csrc/conv_int8.cu',
         'replaces': 'yolo_tpu/ops/pallas_conv.py:132',
         'launches': (launches['conv_int8'] + eval_launches['conv_int8']
                      + new_launches['conv_int8']),
         'max_abs_err': k2_err,
         'ms': k2_tot['ms'], 'device_ms': k2_tot['dev'],
         'plain_ms': k2_tot['plain'], 'bound_ms': k2_tot['bound'],
         'bound_by': k2_tot['by'], 'library_ms': None,
         'ms_1x1': k2_tot['ms_1x1'], 'device_ms_1x1': k2_tot['device_ms_1x1'],
         'library_ms_1x1': k2_tot['library_ms_1x1'],
         'library_device_ms_1x1': k2_tot['library_device_ms_1x1'],
         'classes': k2_tot['classes'],
         'mobilenet_int8': routes}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def main_phase9(root):
    """The child process of phase 9 (``chip_smoke.py --phase9 DIR``)."""
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    sys.path.insert(0, ROOT)
    prune_child(root, dev)


if __name__ == '__main__':
    try:
        if sys.argv[1:2] == ['--phase9']:
            main_phase9(sys.argv[2])
        else:
            main()
    except SmokeFailure as e:
        print(f'FAILED: {e}', file=sys.stderr)
        sys.exit(1)
