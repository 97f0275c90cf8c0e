"""FPGA weight export CLI of the PyTorch port, ``python -m
yolo_tpu_torch.convert_fpga`` (counterpart of the root ``convert_FPGA.py``,
which belongs to the JAX package): every conv BN-fused and quantized with
its calibrated pow-2 scales, written as packed int8 (int16 at 16 bits)
weight and bias binaries and per-layer shift-exponent binaries, optionally
TM/TN-tile-reordered (``compress/fpga_export.export_fpga_weights``).

    python -m yolo_tpu_torch.convert_fpga --cfg cfg/yolov3/yolov3.cfg \\
        --weights weights/PTQ.npz --quantized 3 --out fpga_export

The quantizer state comes from ``<weights>_qstate.npz`` when that file
exists. ``--device`` (default ``cuda``) is where the model loads; the
export itself is numpy on the host. The root CLI's flags that its exporter
never reads (``--data``, ``--source``, ``--output``, ``--img_size``,
``--conf-thres``, ``--nms-thres``, ``--FPGA``) are accepted and ignored.
"""

from __future__ import annotations

import os

from .utils.cli import FlexParser


def parse_args(argv=None):
    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--weights', type=str, default='weights/PTQ.npz')
    p.add_argument('--quantized', type=int, default=3)
    p.add_argument('--a-bit', type=int, default=8)
    p.add_argument('--w-bit', type=int, default=8)
    p.add_argument('--shortcut_way', type=int, default=1)
    p.add_argument('--reorder', action='store_true')
    p.add_argument('--TM', type=int, default=32)
    p.add_argument('--TN', type=int, default=32)
    p.add_argument('--out', type=str, default='fpga_export')
    p.add_argument('--gray-scale', '--gray_scale', dest='gray_scale',
                   action='store_true', help='1-channel model')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    # accepted for the root CLI's sake and ignored: its exporter never
    # reads them
    p.add_argument('--data', type=str, default='')
    p.add_argument('--source', type=str, default='')
    p.add_argument('--output', type=str, default='')
    p.add_argument('--img_size', '--img-size', type=int, default=416)
    p.add_argument('--conf-thres', type=float, default=0.5)
    p.add_argument('--nms-thres', type=float, default=0.5)
    p.add_argument('--FPGA', action='store_true')
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    from .compress.fpga_export import export_fpga_weights
    from .convert import qstate_from_jax
    from .runtime import load_model
    from .utils.checkpoint import load_checkpoint

    bundle = load_model(opt.cfg, opt.weights, device=opt.device,
                        quantized=opt.quantized, a_bit=opt.a_bit,
                        w_bit=opt.w_bit, shortcut_way=opt.shortcut_way,
                        is_gray_scale=opt.gray_scale)
    qpath = opt.weights.replace('.npz', '_qstate.npz')
    if os.path.exists(qpath):
        bundle.qstate = qstate_from_jax(load_checkpoint(qpath)['params'],
                                        bundle.device)
    out = export_fpga_weights(bundle, opt.out, reorder=opt.reorder,
                              TM=opt.TM, TN=opt.TN)
    print(f'FPGA export written to {out}')
    return out


if __name__ == '__main__':
    main()
