"""Training CLI of the PyTorch port, ``python -m yolo_tpu_torch.train``
(counterpart of the root ``train.py``, which belongs to the JAX package).

    python -m yolo_tpu_torch.train --cfg cfg/yolov3/yolov3.cfg \\
        --data data_cfg/coco2014.data --epochs 100 --batch-size 16 \\
        --img-size 416 416 416
    python -m yolo_tpu_torch.train --prune 0 --s 0.001 ...   # sparse training
    python -m yolo_tpu_torch.train --resume ...   # from weights/last.npz

The flags and their defaults are the JAX CLI's; ``--device`` (default
``cuda``; ``cpu`` when asked) picks the device, and the convs compute in
bf16. It writes ``results.txt``,
``train_batch0.jpg`` and ``weights/last.npz``/``best.npz`` in the working
directory. Flags of slices not ported yet raise ``NotImplementedError``
(see ROADMAP.md): ``--quantized`` other than -1, ``--evolve``, ``--bucket``,
``--t_cfg`` (KD), ``--device-aug``, ``--tp`` > 1, ``--remat`` other than
``none`` and the multi-host ones (``--coordinator``, ``--num-hosts``,
``--host-id``).
"""

from __future__ import annotations

from ..compress.quant import unported
from ..utils.cli import FlexParser


def parse_args(argv=None):
    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--data', type=str, default='data_cfg/coco2014.data')
    p.add_argument('--weights', type=str, default='')
    p.add_argument('--epochs', type=int, default=300)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--img-size', nargs='+', type=int, default=[416, 416, 416],
                   help='[min_train, max_train, test]')
    p.add_argument('--multi-scale', action='store_true')
    p.add_argument('--rect', action='store_true')
    p.add_argument('--cache-images', action='store_true')
    p.add_argument('--single-cls', action='store_true')
    p.add_argument('--adam', action='store_true')
    p.add_argument('--ema', action='store_true', default=True)
    p.add_argument('--prune', type=int, default=-1,
                   help='-1 off, 0 normal, 1 shortcut, 2 layer sparse sets')
    p.add_argument('--s', dest='sparsity', type=float, default=0.001,
                   help='BN-gamma L1 sparsity strength')
    p.add_argument('--quantized', type=int, default=-1,
                   help='-1 float (QAT is not ported yet)')
    p.add_argument('--a-bit', type=int, default=8)
    p.add_argument('--w-bit', type=int, default=8)
    p.add_argument('--qat-dtype', default='bf16', choices=['bf16', 'f32'],
                   help='QAT conv compute dtype (QAT is not ported yet)')
    p.add_argument('--no-qat-bn-fast', dest='qat_bn_fast',
                   action='store_false', default=True)
    p.add_argument('--shortcut_way', type=int, default=1)
    p.add_argument('--maxabsscaler', '-mas', action='store_true')
    p.add_argument('--gray-scale', '--gray_scale', dest='gray_scale',
                   action='store_true')
    p.add_argument('--pretrain', '--pt', '-pt', dest='pt',
                   action='store_true',
                   help='skip 255-ch COCO heads when loading .weights')
    p.add_argument('--evolve', action='store_true')
    p.add_argument('--bucket', type=str, default='')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    p.add_argument('--tp', type=int, default=1)
    p.add_argument('--no-mesh', action='store_true',
                   help='accepted for CLI compat; the port trains on one '
                        'device')
    p.add_argument('--remat', default='none',
                   choices=['none', 'blocks', 'full'])
    p.add_argument('--mixedprecision', '-mpt', dest='mpt',
                   action='store_true',
                   help='accepted for CLI compat; compute is always bf16 '
                        'mixed precision')
    p.add_argument('--rank', default=0, help='accepted for CLI compat')
    p.add_argument('--local_rank', type=int, default=-1,
                   help='accepted for CLI compat')
    p.add_argument('--coordinator', type=str, default='')
    p.add_argument('--num-hosts', '--num_hosts', dest='num_hosts', type=int,
                   default=0)
    p.add_argument('--host-id', '--host_id', dest='host_id', type=int,
                   default=-1)
    p.add_argument('--t_cfg', type=str, default='', help='teacher cfg (KD)')
    p.add_argument('--t_weights', type=str, default='')
    p.add_argument('--KDstr', type=int, default=1, help='KD strategy 1-5')
    p.add_argument('--kd5-mask', '--kd5_mask', dest='kd5_mask', type=str,
                   default='diag', choices=['rect', 'diag'])
    p.add_argument('--notest', action='store_true')
    p.add_argument('--nosave', action='store_true')
    p.add_argument('--name', type=str, default='')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--max-targets', '--max_targets', dest='max_targets',
                   type=int, default=0,
                   help='per-batch target capacity; 0 = 30*batch_size')
    p.add_argument('--device-aug', action='store_true')
    p.add_argument('--cutout', action='store_true')
    p.add_argument('--ud-flip', '--ud_flip', dest='ud_flip',
                   action='store_true')
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    if opt.evolve:
        raise unported('--evolve (hyper-parameter evolution)')
    if opt.coordinator or opt.num_hosts or opt.host_id >= 0:
        raise unported('multi-host training (--coordinator)')
    from .loop import TrainOptions, run_training
    img_size = opt.img_size
    img_size.extend([img_size[-1]] * (3 - len(img_size)))
    weights = opt.weights
    if opt.resume and not weights:
        weights = 'weights/last.npz'
    topt = TrainOptions(
        cfg=opt.cfg, data=opt.data, weights=weights, epochs=opt.epochs,
        batch_size=opt.batch_size, img_size=tuple(img_size[:3]),
        multi_scale=opt.multi_scale, rect=opt.rect,
        cache_images=opt.cache_images, single_cls=opt.single_cls,
        adam=opt.adam, ema=opt.ema, prune=opt.prune, sparsity=opt.sparsity,
        quantized=opt.quantized, maxabsscaler=opt.maxabsscaler,
        gray_scale=opt.gray_scale, pt=opt.pt, t_cfg=opt.t_cfg,
        notest=opt.notest, nosave=opt.nosave, seed=opt.seed,
        device_aug=opt.device_aug, cutout=opt.cutout, ud_flip=opt.ud_flip,
        resume=opt.resume, max_targets=opt.max_targets, tp=opt.tp,
        remat=opt.remat, bucket=opt.bucket,
        results_file=f'results{opt.name}.txt' if opt.name else 'results.txt',
        device=opt.device)
    return run_training(topt)


if __name__ == '__main__':
    main()
