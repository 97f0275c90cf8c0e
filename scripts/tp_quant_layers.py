#!/usr/bin/env python3
"""Where the google sim split over a model axis departs from one process's,
layer by layer.

    python3 scripts/tp_quant_layers.py [--batches 2 8]

Two ranks share ``cuda:0`` over gloo on a (data 1, model 2) mesh. Each
builds ``chip_smoke.py`` phase 6's calibrated yolov3 @608 (rank 0's
quantizer state on both), splits its params as ``parallel.shard_state``
does and runs the eval sim with ``capture_trace`` under the model group;
rank 0 also runs the sim on the whole params alone. For cuDNN on and off,
and for each batch size, it prints the first layer whose output differs,
how many layers differ, and per differing layer the values apart and the
largest difference in quanta of that conv's activation grid. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def layers_apart(net, qstate, tp, one):
    """(first layer index apart or None, per differing layer a note)."""
    first, rows = None, []
    for lyr in net.layers:
        k = str(lyr.index)
        d = (tp[k].float() - one[k].float()).abs()
        n = int((d > 0).sum())
        if not n:
            continue
        first = lyr.index if first is None else first
        q = (f'{float(d.max()) / float(qstate[k]["aq"]["scale"]):.2f}q'
             if lyr.kind == 'conv' else f'{float(d.max()):.3g}')
        rows.append(f'{lyr.index} {lyr.kind}: {n}/{d.numel()} by {q}')
    return first, rows


def rank_main(rank, port, batches):
    import torch.distributed as dist
    from yolo_tpu_torch.compress.quant import (make_quant_apply,
                                               prepare_eval_params)
    from yolo_tpu_torch.parallel import init_multihost, make_mesh, shard_state
    from yolo_tpu_torch.parallel.collectives import broadcast_tensors
    from yolo_tpu_torch.parallel.mesh import _tensors
    from yolo_tpu_torch.runtime import preprocess
    dev = init_multihost(f'localhost:{port}', 2, rank)
    card = C.device_setup()
    mesh = make_mesh(dev, model_parallel=2)
    qb, _ = C.int8_bundle(dev, C.BS, C.SIZE)
    broadcast_tensors(_tensors(qb.qstate), dist.group.WORLD)
    net, qcfg = qb.net, qb.qcfg
    apply = make_quant_apply(net, qcfg, capture_trace=True)
    with torch.inference_mode():
        whole = prepare_eval_params(net, qcfg, qb.params, qb.state, qb.qstate)
        p = shard_state(mesh, net, {k: dict(v) for k, v in qb.params.items()})
        s = shard_state(mesh, net, {k: dict(v) for k, v in qb.state.items()})
        split = prepare_eval_params(net, qcfg, p, s, qb.qstate,
                                    model_group=mesh.model_group)
    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        for bs in batches:
            x = preprocess(C.images(72, bs, C.SIZE), device=dev)
            with torch.inference_mode():
                tp = apply(split, s, qb.qstate, x, False,
                           model_group=mesh.model_group)[-1]
                one = (apply(whole, qb.state, qb.qstate, x, False)[-1]
                       if rank == 0 else None)
            if rank == 0:
                first, rows = layers_apart(net, qb.qstate, tp, one)
                print(f'cuDNN {"on" if cudnn else "off"}, bs {bs}: first '
                      f'layer apart {first}, {len(rows)} layers apart; '
                      f'first {rows[:6]}; last {rows[-2:]} ({card})',
                      flush=True)
            del tp, one
            torch.cuda.empty_cache()
    torch.backends.cudnn.enabled = True
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batches', type=int, nargs='+', default=[2, C.BS])
    opt = ap.parse_args()
    C.phase_device()
    C.phase_build()
    port = C.free_ports(1)[0]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               '--rank', str(r), str(port)]
                              + [str(b) for b in opt.batches])
             for r in range(2)]
    try:
        rc = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    sys.exit(max(rc))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank']:
        rank_main(int(sys.argv[2]), sys.argv[3],
                  [int(b) for b in sys.argv[4:]])
    else:
        main()
