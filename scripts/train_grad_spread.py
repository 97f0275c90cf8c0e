#!/usr/bin/env python3
"""How far f32 training gradients of yolov3 move with the summation order,
and how far each is from the f64 gradient.

    python3 scripts/train_grad_spread.py [--size 320] [--bs 2]

One ``grad_fn`` of ``cfg/yolov3/yolov3.cfg`` at full width on the inputs
of ``chip_smoke.py`` phase 10 (a) (random weights from seed 0,
``conv_scale`` 0.7, a seeded labelled batch), computed five ways: in f64
on the CPU (the reference: convs, BN statistics and loss in f64), and in
f32 on the CPU with 8 threads and with 1, and on the card (TF32 off)
with cuDNN and without it (PyTorch's own CUDA convs). For each f32 run it
prints the relative L2 error against the f64 run and against the CPU's
f32 at 8 threads (the run phase 10 (a) holds the card to): of the whole
gradient, of the worst tensors, of the three head convs (no BN behind
them) and of the new BN state. This is the reading phase 10 (a)'s
``GRAD_F64_RATIO`` and ``GRAD_BN_TOL`` rest on. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--size', type=int, default=C.GRAD_SIZE)
    ap.add_argument('--bs', type=int, default=C.GRAD_BS)
    opt = ap.parse_args()
    card = C.device_setup()
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import init_params
    net = build_ir(C.CFG)
    params, state = init_params(net, torch.Generator().manual_seed(0),
                                conv_scale=C.CONV_SCALE)
    heads = {str(l.index) for l in net.layers if l.kind == 'conv'
             and not l.bn}
    threads = torch.get_num_threads()
    runs = {}
    for name, dev, n_threads, cudnn, dtype in (
            ('cpu, f64', 'cpu', threads, True, torch.float64),
            ('cpu, 8 threads', 'cpu', 8, True, None),
            ('cpu, 1 thread', 'cpu', 1, True, None),
            ('card, cuDNN', 'cuda', threads, True, None),
            ('card, no cuDNN', 'cuda', threads, False, None)):
        torch.set_num_threads(n_threads)
        torch.backends.cudnn.enabled = cudnn
        t0 = time.perf_counter()
        runs[name] = C.grad_run(net, params, state, torch.device(dev), dtype,
                                opt.size, opt.bs)[:2]
        print(f'{name}: {time.perf_counter() - t0:.2f} s')
    torch.set_num_threads(threads)
    torch.backends.cudnn.enabled = True
    refs = {'f64': runs.pop('cpu, f64'), 'cpu f32': runs['cpu, 8 threads']}
    print(f'yolov3 @{opt.size}, bs={opt.bs}, f32; relative L2 error ({card}):')
    for ref_name, (ref_g, ref_bn) in refs.items():
        print(f' against {ref_name}:')
        for name, run in runs.items():
            if run is refs[ref_name]:
                continue
            g, bn = run
            per, whole = C.rel_l2(g, ref_g)
            worst = sorted(per.items(), key=lambda kv: -kv[1])[:3]
            head = max(e for k, e in per.items() if k.split('.')[0] in heads)
            bn_per, _ = C.rel_l2(bn, ref_bn)
            print(f'  {name}: all {whole:.2e}; worst '
                  f'{", ".join(f"{k} {e:.2e}" for k, e in worst)}; head '
                  f'convs {head:.2e}; BN state {max(bn_per.values()):.2e}')


if __name__ == '__main__':
    main()
