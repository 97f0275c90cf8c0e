"""mAP evaluation CLI of the PyTorch port (counterpart of the root
``test.py``, which belongs to the JAX package).

    python -m yolo_tpu_torch.test --cfg cfg/yolov3/yolov3.cfg \\
        --data data_cfg/coco2014.data --weights weights/last.npz

    python -m yolo_tpu_torch.test --cfg ... --data ... \\
        --weights weights/PTQ.npz --quantized 3 [--int8-engine]

    python -m yolo_tpu_torch.test --cfg ... --data ... \\
        --weights weights/best.pt --augment

Tasks: ``test`` (the P/R/mAP/F1 table), ``study`` (an image-size sweep at
the CLI's IoU threshold -> ``study_<data>_<cfg>.txt``) and ``benchmark``
(sizes 256-512 x NMS IoU {0.6, 0.7} -> ``benchmark.txt``). It runs on the
card unless ``--device cpu``. ``--quantized N`` (1 google, 2 TPSQ, 3
cos-PTQ, 4 DoReFa, 5 binary, 6 ternary weights) evaluates the fake-quant
sim of a quantized checkpoint (its ``qstate`` key or a sibling
``_qstate.npz``), ``--int8-engine`` the true-int8 engine (K2 convs) of a
google, TPSQ or cos-PTQ one; ``--qat-eval-snap bf16`` runs the sim's eval
grid snaps in bf16. ``--augment`` runs test-time augmentation on a float
model (a quantized one warns and runs a single pass). ``--weights`` takes
a .npz of the JAX package, a .pt of the PyTorch reference or darknet
.weights.
"""

from __future__ import annotations

import os

import torch

from .utils.cli import FlexParser


def parse_args(argv=None):
    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--data', type=str, default='data_cfg/coco2014.data')
    p.add_argument('--weights', type=str, default='weights/last.npz')
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--img-size', type=int, default=416)
    p.add_argument('--conf-thres', type=float, default=0.001)
    p.add_argument('--iou-thres', type=float, default=0.6)
    p.add_argument('--save-json', action='store_true')
    p.add_argument('--task', default='test',
                   help="'test' | 'study' | 'benchmark'")
    p.add_argument('--sweep-sizes', nargs='+', type=int, default=None,
                   help='override the img-size sweep for study/benchmark')
    p.add_argument('--quantized', type=int, default=-1,
                   help='-1 float, 1 google QAT, 2 TPSQ, 3 cos-PTQ, '
                        '4 DoReFa, 5 binary-W, 6 ternary-W')
    p.add_argument('--a-bit', type=int, default=8)
    p.add_argument('--w-bit', type=int, default=8)
    p.add_argument('--shortcut_way', type=int, default=1)
    p.add_argument('--gray-scale', '--gray_scale', dest='gray_scale',
                   action='store_true')
    p.add_argument('--maxabsscaler', '-mas', action='store_true')
    p.add_argument('--single-cls', action='store_true')
    p.add_argument('--augment', action='store_true',
                   help='test-time augmentation (float models)')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    p.add_argument('--int8-engine', action='store_true',
                   help='evaluate the true-int8 engine (K2 convs) instead of '
                        'the fake-quant sim; needs --quantized 1, 2 or 3 '
                        'and a calibrated checkpoint')
    p.add_argument('--qat-eval-snap', default='f32', choices=['f32', 'bf16'],
                   help='fake-quant eval grid-snap dtype (bf16 rounds the '
                        'quantize chains in bf16; --quantized only)')
    p.add_argument('--no-plot', action='store_true',
                   help='skip the test_batch0_gt/pred.jpg mosaics')
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    if opt.int8_engine and opt.quantized not in (1, 2, 3):
        raise SystemExit('--int8-engine requires --quantized {1,2,3}')

    from .eval.evaluator import evaluate, int8_engine_apply
    from .runtime import load_model

    bundle = load_model(opt.cfg, opt.weights, device=opt.device,
                        quantized=opt.quantized, a_bit=opt.a_bit,
                        w_bit=opt.w_bit, shortcut_way=opt.shortcut_way,
                        is_gray_scale=opt.gray_scale,
                        maxabsscaler=opt.maxabsscaler,
                        eval_snap_dtype=(torch.bfloat16
                                         if opt.qat_eval_snap == 'bf16'
                                         else None))
    if not bundle.quantized:
        bundle = bundle.fuse()      # BN folded for eval

    eval_params, eval_state = bundle.params, bundle.state
    eval_qapply = eval_qstate = None
    if bundle.quantized:
        eval_qapply = bundle.quant_apply()
        eval_qstate = bundle.qstate
    if opt.int8_engine:
        eval_params, eval_qapply = int8_engine_apply(
            bundle.net, bundle.params, bundle.state, bundle.qstate,
            bundle.qcfg, bundle.device)
        eval_state, eval_qstate = {}, None
    kw = dict(batch_size=opt.batch_size, conf_thres=opt.conf_thres,
              fused=not bundle.quantized, single_cls=opt.single_cls,
              is_gray_scale=opt.gray_scale, maxabsscaler=opt.maxabsscaler,
              quant_apply=eval_qapply, qstate=eval_qstate,
              augment=opt.augment, device=bundle.device)

    if opt.task in ('benchmark', 'study'):
        import time

        import numpy as np
        if opt.task == 'benchmark':
            sizes = opt.sweep_sizes or list(range(256, 640, 128))
            ious = (0.6, 0.7)
            out_file = 'benchmark.txt'
        else:
            sizes = opt.sweep_sizes or list(range(288, 896, 64))
            ious = (opt.iou_thres,)
            cfg_tag = os.path.splitext(os.path.basename(opt.cfg))[0]
            data_tag = os.path.splitext(os.path.basename(opt.data))[0]
            out_file = f'study_{data_tag}_{cfg_tag}.txt'
        results = []
        for size in sizes:
            for iou in ious:
                t0 = time.time()
                r, _, _ = evaluate(bundle.net, eval_params, eval_state,
                                   opt.data, img_size=size, iou_thres=iou,
                                   **kw)
                # row: size, iou, P, R, mAP@0.5, F1, val losses, wall time
                results.append((size, iou) + tuple(r) + (time.time() - t0,))
        np.savetxt(out_file, np.asarray(results), fmt='%10.4g')
        for row in results:
            print(row)
        return results

    r, maps, t = evaluate(bundle.net, eval_params, eval_state, opt.data,
                          img_size=opt.img_size, iou_thres=opt.iou_thres,
                          save_json=opt.save_json, verbose=True,
                          plot=not opt.no_plot, **kw)
    print(f'speed: {t[0]:.3f}s inference+nms total')
    return r


if __name__ == '__main__':
    main()
