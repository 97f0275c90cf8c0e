"""Training CLI of the PyTorch port, ``python -m yolo_tpu_torch.train``
(counterpart of the root ``train.py``, which belongs to the JAX package).

    python -m yolo_tpu_torch.train --cfg cfg/yolov3/yolov3.cfg \\
        --data data_cfg/coco2014.data --epochs 100 --batch-size 16 \\
        --img-size 416 416 416
    python -m yolo_tpu_torch.train --prune 0 --s 0.001 ...   # sparse training
    python -m yolo_tpu_torch.train --resume ...   # from weights/last.npz
    python -m yolo_tpu_torch.train --quantized 1 --weights float.npz ...  # QAT
    python -m yolo_tpu_torch.train --t_cfg teacher.cfg \
        --t_weights teacher.npz --KDstr 5 ...   # knowledge distillation
    python -m yolo_tpu_torch.train --evolve ...   # one evolve generation
    python -m yolo_tpu_torch.train --coordinator HOST:PORT --num-hosts N \
        --host-id I ...                             # rank I of N processes
    torchrun --nproc-per-node N -m yolo_tpu_torch.train --coordinator auto ...

The flags and their defaults are the JAX CLI's; ``--device`` (default
``cuda``; ``cpu`` when asked) picks the device, and the convs compute in
bf16. It writes ``results.txt``,
``train_batch0.jpg`` and ``weights/last.npz``/``best.npz`` in the working
directory. ``--quantized N`` (1 google, 2 TPSQ, 3 cos-PTQ, 4 DoReFa, 5
binary, 6 ternary weights) trains the quantized model (QAT) with
``--a-bit``, ``--w-bit``, ``--shortcut_way``, ``--qat-dtype`` and
``--no-qat-bn-fast``. ``--t_cfg``/``--t_weights`` distil from a teacher
with strategy ``--KDstr`` 1-6 (KD5's mask ``--kd5-mask``). ``--evolve``
runs one generation of hyper-parameter evolution: a hyp mutated from
``evolve.txt`` (or the defaults), a run without evaluation until the last
epoch and without checkpoints, its results appended to ``evolve.txt``.
``--device-aug`` runs mosaic, affine, HSV and flip on the device.
``--bucket B`` copies ``results<name>.txt`` (with ``--name``) to
``gs://B`` after each epoch and the checkpoints at the end, and with
``--evolve`` shares ``evolve.txt`` there (``gsutil cp``).

``--coordinator HOST:PORT`` with ``--num-hosts N`` and ``--host-id I``
(or ``auto``: torchrun's ``env://`` variables) joins a data-parallel job
of N processes, one rank each, through ``parallel.init_multihost`` (NCCL
when every rank of a host has a card of its own, gloo otherwise); rank r
of a host with c cards trains on ``cuda:{r % c}``. ``--batch-size`` is the
global batch. Without ``--coordinator`` the process trains alone, as with
``--no-mesh``. ``--tp K`` splits the job's ranks into a (data, model) mesh
with a model axis of K: the output channels of the convs whose filters
divide by K are split over it (tensor parallelism), QAT's
(``--quantized``) included; with one process it is ignored, as in the JAX
package. ``--remat blocks|full`` recomputes activations in the backward
(``blocks``: all but the block boundaries).
"""

from __future__ import annotations

from ..parallel.multihost import process_index
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
                   help='-1 float, 1 google QAT, 2 TPSQ, 3 cos-PTQ, '
                        '4 DoReFa, 5 binary-W, 6 ternary-W')
    p.add_argument('--a-bit', type=int, default=8)
    p.add_argument('--w-bit', type=int, default=8)
    p.add_argument('--qat-dtype', default='bf16', choices=['bf16', 'f32'],
                   help='QAT conv compute dtype: bf16 (default; quantizer/'
                        'tracker/BN-fold math stays f32) or f32')
    p.add_argument('--no-qat-bn-fast', dest='qat_bn_fast',
                   action='store_false', default=True,
                   help='keep the parallel float BN-stat conv after '
                        'BN_freeze_step (reference-exact trajectory) '
                        'instead of switching to the stat-conv-free step')
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
                   help='train alone, without the data-parallel mesh')
    p.add_argument('--remat', default='none',
                   choices=['none', 'blocks', 'full'])
    p.add_argument('--mixedprecision', '-mpt', dest='mpt',
                   action='store_true',
                   help='accepted for CLI compat; compute is always bf16 '
                        'mixed precision')
    p.add_argument('--rank', default=0, help='accepted for CLI compat')
    p.add_argument('--local_rank', type=int, default=-1,
                   help='accepted for CLI compat')
    p.add_argument('--coordinator', type=str, default='',
                   help="HOST:PORT of rank 0's store, or 'auto' (torchrun's "
                        "env:// variables): join a data-parallel job")
    p.add_argument('--num-hosts', '--num_hosts', dest='num_hosts', type=int,
                   default=0, help='the processes of the job (WORLD_SIZE)')
    p.add_argument('--host-id', '--host_id', dest='host_id', type=int,
                   default=-1, help='this process of the job (RANK)')
    p.add_argument('--t_cfg', type=str, default='', help='teacher cfg (KD)')
    p.add_argument('--t_weights', type=str, default='')
    p.add_argument('--KDstr', type=int, default=1, help='KD strategy 1-6')
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
    if opt.coordinator:
        from ..parallel import init_multihost
        if opt.coordinator == 'auto':
            dev = init_multihost(device=opt.device)
        else:
            dev = init_multihost(
                opt.coordinator, num_processes=opt.num_hosts or None,
                process_id=opt.host_id if opt.host_id >= 0 else None,
                device=opt.device)
        opt.device = str(dev)
    from .loop import TrainOptions, run_training
    img_size = opt.img_size
    img_size.extend([img_size[-1]] * (3 - len(img_size)))
    weights = opt.weights
    if opt.resume and not weights:
        weights = 'weights/last.npz'
    hyp_override = None
    if opt.evolve:
        # one generation a call: mutate from evolve.txt (or the defaults),
        # train without evaluation and checkpoints, append the result
        from ..config import load_hyp
        from .evolve import mutate_hyp
        opt.notest, opt.nosave = True, True
        if opt.bucket:
            # the fleet's evolve.txt first
            from ..utils import gsutil
            gsutil.download_evolve(opt.bucket)
        hyp_override = mutate_hyp(load_hyp(None))
    topt = TrainOptions(
        cfg=opt.cfg, data=opt.data, weights=weights, epochs=opt.epochs,
        batch_size=opt.batch_size, img_size=tuple(img_size[:3]),
        multi_scale=opt.multi_scale, rect=opt.rect,
        cache_images=opt.cache_images, single_cls=opt.single_cls,
        adam=opt.adam, ema=opt.ema, prune=opt.prune, sparsity=opt.sparsity,
        quantized=opt.quantized, a_bit=opt.a_bit, w_bit=opt.w_bit,
        shortcut_way=opt.shortcut_way, qat_dtype=opt.qat_dtype,
        qat_bn_fast=opt.qat_bn_fast, maxabsscaler=opt.maxabsscaler,
        gray_scale=opt.gray_scale, pt=opt.pt, t_cfg=opt.t_cfg,
        t_weights=opt.t_weights, kd_strategy=opt.KDstr,
        kd5_mask=opt.kd5_mask, notest=opt.notest, nosave=opt.nosave,
        seed=opt.seed, device_aug=opt.device_aug, cutout=opt.cutout,
        ud_flip=opt.ud_flip, resume=opt.resume, hyp_override=hyp_override,
        max_targets=opt.max_targets, tp=opt.tp,
        device_mesh=False if opt.no_mesh else None, remat=opt.remat,
        bucket=opt.bucket, name=opt.name,
        results_file=f'results{opt.name}.txt' if opt.name else 'results.txt',
        device=opt.device)
    try:
        results = run_training(topt)
        if opt.evolve and process_index() == 0:
            from .evolve import print_mutation
            print_mutation(hyp_override, results, bucket=opt.bucket)
    finally:
        if opt.coordinator:
            # the job this call joined ends with it
            import torch.distributed as dist
            dist.destroy_process_group()
    return results


if __name__ == '__main__':
    main()
