#!/usr/bin/env python3
"""K2 (the port's fused int8 conv, ``yolo_tpu_torch/csrc/conv_int8.cu``) on
one CUDA card: correctness at the tile edges, then a sweep of its tiles.

    python3 scripts/k2_sweep.py [--check-only] [--out FILE.json]

1. Builds the kernels from the sources and prints what ptxas reported for
   the conv kernels (registers, spills, shared memory) and the tensor-core
   instructions in their SASS (``cuobjdump -sass``).
2. Holds the kernel against ``fused_conv_int8_reference`` on the smallest
   case first, then on the edge cases of the tile plan (pixels not a
   multiple of 128, Cout 32 and 255, Cin 6, 16, 32 and 1024, K*K*Cin up to
   4608, stride 2 on odd sizes, f32 output) under every BN and ring depth
   the kernel takes: int8 outputs bit-equal (mish within 1 LSB), f32
   within rtol 1e-6.
3. Unless ``--check-only``: for each distinct int8 conv shape of yolov3
   @608 at bs=8, the median device time (``chip_smoke.device_ms``) of
   every (BN, stages) the kernel takes, beside the plan's choice and the
   shape's bound, and the summed time of the 74 convs under the plan and
   under the best choice per shape; ``--out`` writes every time to a JSON
   file.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the smoke run's inputs, bounds, timer)


def report_build():
    from yolo_tpu_torch import _build
    t0 = time.perf_counter()
    lib = _build.build()
    print(f'built {os.path.relpath(lib, ROOT)} in '
          f'{time.perf_counter() - t0:.2f} s')
    for line in _build.build_log().splitlines():
        if 'conv_int8' in line or ('Used' in line and 'registers' in line) \
                or 'spill' in line or 'warning' in line.lower():
            print('  ' + line.strip())
    ops = cs.conv_sass(lib)
    print(f'  SASS of the conv kernels: {ops}')
    return ops


def check_case(case, bn=None, stages=None):
    """Kernel vs plain version on one case; the plan's tiles unless bn and
    stages are given. Returns (ok, message)."""
    from yolo_tpu_torch.ops import conv_int8 as K
    n, h, w, ci, co, k, s, act, out_q, maxabs = case
    x8, w8, bias, sc, osc = cs.k2_inputs(case, 'cuda')
    kw = dict(stride=s, act=act, out_q=out_q, maxabs=maxabs)
    if bn is None:
        got = K.fused_conv_int8(x8, w8, bias, sc, osc, **kw)
    else:
        xp, wp = K.pad_cin(x8, w8)
        ho = (h + 2 * (k // 2) - k) // s + 1
        wo = (w + 2 * (k // 2) - k) // s + 1
        got = torch.empty((n, ho, wo, co), device='cuda',
                          dtype=torch.int8 if out_q else torch.float32)
        K._launch(xp, wp, bias, got, s, float(cs.np.float32(sc)),
                  float(cs.np.float32(1.0) / cs.np.float32(osc)), act,
                  0.25 if maxabs else 0.1, out_q, -128, 127, bn, stages,
                  K.run_tile(co, bn, out_q))
    torch.cuda.synchronize()
    want = K.fused_conv_int8_reference(x8, w8, bias, sc, osc, **kw)
    d = (got.double() - want.double()).abs()
    if act == 'mish' and out_q:
        ok = float(d.max()) <= 1 and float((d > 0).double().mean()) <= 1e-3
    elif not out_q:
        ok = bool(torch.allclose(got, want, rtol=1e-6, atol=0))
    else:
        ok = torch.equal(got, want)
    return ok, (f'max err {float(d.max()):.3g}, {int((d > 0).sum())} of '
                f'{d.numel()} differ')


# (N, H, W, Cin, Cout, K, stride, act, out_q, maxabs): the tile edges
EDGE_CASES = [
    (1, 5, 7, 16, 48, 1, 1, 'relu', True, False),
    (3, 23, 17, 32, 32, 3, 1, 'leaky', True, False),
    (1, 61, 61, 32, 64, 3, 1, 'leaky', True, False),
    (2, 19, 19, 1024, 255, 1, 1, 'linear', True, False),
    (2, 19, 19, 1024, 512, 1, 1, 'leaky', True, False),
    (1, 19, 19, 512, 1024, 3, 1, 'leaky', True, False),
    (2, 37, 29, 64, 128, 3, 2, 'leaky', True, False),
    (1, 38, 38, 512, 1024, 3, 2, 'leaky', True, False),
    (2, 13, 11, 48, 96, 3, 2, 'leaky', False, False),
    (2, 21, 21, 256, 255, 1, 1, 'linear', False, False),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--check-only', action='store_true')
    ap.add_argument('--out', help='JSON file for every time of the sweep')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('k2_sweep.py needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True)
    card = smi.stdout.strip()
    print(f'{card}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    torch.backends.cudnn.allow_tf32 = False
    ops = report_build()
    from yolo_tpu_torch.ops import conv_int8 as K

    first = EDGE_CASES[0]
    ok, msg = check_case(first)
    print(f'first case {first}: {"ok" if ok else "FAILED"} ({msg})')
    if not ok:
        sys.exit(1)
    bad = 0
    for case in cs.K2_CASES + EDGE_CASES:
        ok, msg = check_case(case)
        bad += not ok
        plan = K.tile_plan(case[0] * case[1] * case[2], *case[3:6], case[8])
        print(f'  {"ok" if ok else "FAILED"}: {case} plan {plan[:2]} ({msg})')
    for bn in K.BN_CHOICES:
        for stages in (2, 3, 4, 6):
            if K.smem_bytes(bn, stages) > K.SMEM_LIMIT:
                continue
            for case in ((2, 23, 17, 96, 255, 3, 1, 'leaky', True, False),
                         (2, 15, 13, 32, 200, 3, 2, 'leaky', False, False),
                         (2, 9, 11, 64, 40, 1, 1, 'leaky', True, False)):
                run = K.run_tile(case[4], bn, case[8])
                if K.smem_bytes(bn, stages, run) > K.SMEM_LIMIT:
                    continue
                ok, msg = check_case(case, bn, stages)
                bad += not ok
                if not ok:
                    print(f'  FAILED: {case} bn={bn} stages={stages} ({msg})')
    print(f'{bad} failures; SASS {ops}')
    if bad or args.check_only:
        sys.exit(1 if bad else 0)

    shapes = cs.int8_conv_shapes()
    count = collections.Counter(shapes)
    rows, plan_ms, best_ms = [], 0.0, 0.0
    for shape, times in count.items():
        n, h, w, ci, co, k, s = shape
        case = (*shape, 'leaky', True, False)
        x8, w8, bias, sc, osc = cs.k2_inputs(case, 'cuda')
        ho = (h + 2 * (k // 2) - k) // s + 1
        out = torch.empty((n, ho, ho, co), device='cuda', dtype=torch.int8)
        plan = K.tile_plan(n * ho * ho, ci, co, k)
        res = {}
        for bn in K.BN_CHOICES:
            for stages in (2, 3, 4, 5, 6):
                if K.smem_bytes(bn, stages, K.run_tile(co, bn, True)) \
                        > K.SMEM_LIMIT:
                    continue
                res[(bn, stages)] = cs.device_ms(lambda: K._launch(
                    x8, w8, bias, out, s, 2.0 ** -9, 1.0 / osc, 'leaky', 0.1,
                    True, -128, 127, bn, stages, K.run_tile(co, bn, True)),
                    iters=10, warmup=2)
        b_ms, b_by = cs.k2_bound(x8, w8, out)
        best = min(res, key=res.get)
        plan_ms += times * res[(plan.bn, plan.stages)]
        best_ms += times * res[best]
        rows.append(dict(shape=shape, times=times, bound_ms=b_ms, by=b_by,
                         plan=(plan.bn, plan.stages),
                         ms={f'{b}x{st}': v for (b, st), v in res.items()}))
        print(f'{shape} x{times}: plan {plan.bn}x{plan.stages} '
              f'{res[(plan.bn, plan.stages)]:.4f} ms, best {best[0]}x{best[1]} '
              f'{res[best]:.4f} ms, bound {b_ms:.5f} ms by {b_by}; '
              + ' '.join(f'{b}x{st}:{v:.4f}' for (b, st), v in res.items()))
    print(f'74 convs: plan {plan_ms:.3f} ms, best per shape {best_ms:.3f} ms '
          f'({card})')
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(card=card, plan_ms=plan_ms, best_ms=best_ms,
                           rows=rows), f, indent=1)


if __name__ == '__main__':
    main()
