#!/usr/bin/env python3
"""K2 (the port's fused int8 conv) over one yolov3 @608 bs=8 int8 batch,
under both of ``chip_smoke.py``'s timers, with the host time of its
wrapper, for the port of a given checkout.

    python3 scripts/k2_timers.py [--root DIR]

``--root`` names a checkout of this repo (default: this one) whose
``yolo_tpu_torch`` is built and imported, so that two versions of the
kernel (a parent commit unpacked with ``git archive`` into a git-ignored
directory, say) are timed by the same code in one run; the inputs, timers
and bounds are this checkout's ``chip_smoke.py``. For each of the 74 int8
convs (every conv but the float stem, from the cfg), on random inputs from
a seed, it takes ``fused_conv_int8``'s median ``cuda_ms`` (what a caller
waits for) and ``device_ms`` (the device alone), the wrapper's host time
per call (calls queued back to back, wall time over their number; the
median of several runs), and on the 1x1 convs ``torch._int_mm`` of the
same product under both timers.
Prints the sums by class, then the card's name and power limit, and last
one JSON line with the totals.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (inputs, timers and bounds)


def host_us(fn, calls=20, reps=7):
    """Host time of one ``fn()`` in microseconds: the median over ``reps``
    runs of ``calls`` calls queued back to back after a sync, each run's
    wall time over ``calls``."""
    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=ROOT,
                    help='checkout whose yolo_tpu_torch is timed')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('k2_timers.py needs a CUDA card')
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from yolo_tpu_torch import _build
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    t0 = time.perf_counter()
    _build.load_library()
    print(f'{os.path.relpath(root, ROOT) or "."}: built in '
          f'{time.perf_counter() - t0:.2f} s '
          f'({os.path.relpath(_build.library_path(), ROOT)})')

    sums = collections.defaultdict(float)
    for shape, times in collections.Counter(cs.int8_conv_shapes()).items():
        n, h, w, ci, co, k, s = shape
        x8, w8, bias, sc, osc = cs.k2_inputs((*shape, 'leaky'), 'cuda')
        call = lambda: fused_conv_int8(x8, w8, bias, sc, osc, stride=s)
        ms = cs.cuda_ms(call, iters=10, warmup=2)
        dev = cs.device_ms(call, iters=10, warmup=2)
        host = host_us(call)
        cls = cs.k2_class(k, s)
        for key, v in (('ms', ms), ('device_ms', dev), ('host_us', host)):
            sums[key] += times * v
            sums[f'{cls} {key}'] += times * v
        sums['calls'] += times
        line = (f'  {shape} x{times}: {ms:.4f} ms, device alone {dev:.4f} '
                f'ms, host {host:.1f} us')
        if k == 1:
            lib = cs.int_mm_ms(x8, w8, iters=10, warmup=2)
            sums['library_ms_1x1'] += times * lib[0]
            sums['library_device_ms_1x1'] += times * lib[1]
            line += f'; torch._int_mm {lib[0]:.4f} ms, device {lib[1]:.4f} ms'
        print(line)
    calls = int(sums.pop('calls'))
    host_total = sums['host_us']
    for cls in ('3x3 s1', '3x3 s2', '1x1'):
        print(f'  {cls}: {sums[f"{cls} ms"]:.4f} ms, device alone '
              f'{sums[f"{cls} device_ms"]:.4f} ms, host '
              f'{sums[f"{cls} host_us"] / 1e3:.3f} ms')
    print(f'{calls} convs: {sums["ms"]:.4f} ms, device alone '
          f'{sums["device_ms"]:.4f} ms; wrapper host time '
          f'{host_total / calls:.1f} us a call, {host_total / 1e3:.3f} ms a '
          f'batch; 1x1 torch._int_mm {sums["library_ms_1x1"]:.4f} ms, device '
          f'alone {sums["library_device_ms_1x1"]:.4f} ms')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({'root': os.path.relpath(root, ROOT), 'calls': calls,
                      'host_us_per_call': host_total / calls,
                      **sums}))


if __name__ == '__main__':
    main()
