"""The training loop (counterpart of ``yolo_tpu/train/loop.py``).

Host-side orchestration around ``grad_fn``/``update_fn``: the augmenting
loader's prefetch thread, the burn-in and LR scalars, multi-scale sizes,
``evaluate`` on the EMA pair at each epoch's end, ``results.txt``, the
``.npz`` checkpoints (``last.npz``/``best.npz``, readable by the JAX
package) and ``--resume``.

Nothing in the step copies from pageable host memory or reads a device
value: each batch goes up from pinned memory without blocking, the loss's
running mean stays on the device and is read only at log points, and the
optimizer's scalars are host floats.

Quantized training (``quantized`` 1-6, QAT): the model loads with its
quantizer (``steps`` = the run's batches, which set the freeze steps), TPSQ
scales start from ``tpsq_warmup`` on one train batch unless the weights
already hold trained ones, the optimizer is Adam on the MultiStep schedule,
and the step runs ``make_quant_apply`` in train mode: bf16 MACs with f32
quantizer math and bf16 eval snaps (``qat_dtype='bf16'``), or f32 all
through. Once the quantizer steps pass ``bn_freeze_step`` the step switches
to the apply without the BN statistics conv (``make_bn_frozen``) unless
``qat_bn_fast`` is off. Each epoch evaluates the sim, and the checkpoints
hold ``qstate``.

Knowledge distillation (``t_cfg``): the teacher loads from ``t_cfg`` and
``t_weights`` in bf16 on the student's device, unfused, and
``train/kd.make_kd_loss_fn`` adds strategy ``kd_strategy``'s term to every
step (KD5 with ``kd5_mask``). The heads stay NHWC except for KD6, which
needs them anchor-major; KD combines with QAT.

Device augmentation (``device_aug``): the dataset only decodes and
letterboxes, and mosaic, affine, HSV and flip run on the device
(``data/device_aug.py``) after ``preprocess`` and before the multi-scale
resize, from a generator on the device seeded ``seed * 100003 + ni`` at
each batch ``ni``.

``bucket``: ``results.txt`` is copied to the gsutil bucket after each
epoch (with ``name``) and the checkpoints at the end (``utils/gsutil.py``).

Across processes (a ``torch.distributed`` job of several ranks, one rank a
process, ``parallel.init_multihost``): the mesh is built unless
``device_mesh`` is False, which a job of several ranks refuses. Each rank
loads its ``process_shard`` of the train set at the local batch
``batch_size // ranks`` (``max_targets // ranks`` targets), starts from
rank 0's state (``parallel.shard_state``), and steps through the
data-parallel ``grad_fn``/``update_fn`` (``trainer.py``): every rank holds
the same weights, and its log lines show the global batch's losses. With
``device_aug`` the ranks all-gather their uint8 blocks and targets, each
augments the global batch with the same draws and keeps its own rows, as
the JAX package augments its global batch. Every rank evaluates its shard
(``evaluate(mesh=...)``, the eval batch rounded up to the ranks); rank 0
alone writes ``results.txt``, the checkpoints, the plots, TensorBoard and
the bucket's copies. ``rect`` and ``image_weights`` need one process.

Tensor parallelism (``tp`` > 1, as JAX's rule: with one rank there is no
mesh and no error): the job's mesh has a model axis of ``tp``, the state is
split over it (``parallel.shard_state``), and the ranks of one data index
load the same rows (``process_shard`` over the data axis). Each epoch's
``evaluate`` runs on the split EMA pair; the checkpoints hold whole
tensors, gathered over the model group on every rank and written by rank
0, so that JAX's loader and one process read them, and ``resume`` splits
them again. QAT under a model axis (``tp`` with ``quantized``) steps the
quant apply with the model group (``trainer.py``): ``qstate`` and TPSQ's
scales stay whole on every rank, the TPSQ warmup runs on the whole params
before the state is split, each epoch's ``evaluate`` runs the sim on the
split EMA pair, and the checkpoints hold ``qstate`` as one process's.

``remat`` ('none', 'blocks', 'full') reaches ``make_train_functions``.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..compress.prune import (prunable_sets_layer, prunable_sets_normal,
                              prunable_sets_shortcut)
from ..compress.quant import make_quant_apply, tpsq_warmup
from ..config import load_hyp, parse_data_cfg
from ..convert import (from_jax, opt_state_from_jax, opt_state_to_jax,
                       qstate_to_jax, to_jax)
from ..data.datasets import BatchLoader, DetectionDataset
from ..data.device_aug import make_device_augment, rows_of
from ..eval.evaluator import evaluate
from ..eval.metrics import fitness
from ..parallel import (DATA_AXIS, MODEL_AXIS, allgather_host_values,
                        gather_state, make_mesh, shard_state)
from ..parallel.collectives import all_reduce_nograd
from ..parallel.multihost import process_count, process_index
from ..runtime import load_model, preprocess
from ..utils import gsutil
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .kd import make_kd_loss_fn
from .loss import LossHyp
from .schedules import burn_in_scalars
from .trainer import init_train_state, make_train_functions


@dataclass
class TrainOptions:
    """The training flags (the JAX package's ``TrainOptions``, plus
    ``device``)."""
    cfg: str = 'cfg/yolov3/yolov3.cfg'
    data: str = 'data_cfg/coco2014.data'
    weights: str = ''
    epochs: int = 300
    batch_size: int = 16
    img_size: tuple = (416, 416, 416)       # (min, max, test)
    multi_scale: bool = False
    rect: bool = False
    cache_images: bool = False
    single_cls: bool = False
    adam: bool = False
    ema: bool = True
    prune: int = -1                          # -1 off, 0 normal, 1 shortcut, 2 layer
    sparsity: float = 0.0                    # --s BN-gamma L1 strength
    quantized: int = -1
    a_bit: int = 8
    w_bit: int = 8
    shortcut_way: int = 1
    maxabsscaler: bool = False
    gray_scale: bool = False
    pt: bool = False
    t_cfg: str = ''                          # teacher cfg (KD)
    t_weights: str = ''
    kd_strategy: int = 1
    kd5_mask: str = 'diag'                   # 'diag' (the reference's
                                             # diagonal footprint) or 'rect'
    notest: bool = False
    nosave: bool = False
    weights_dir: str = 'weights'
    results_file: str = 'results.txt'
    bucket: str = ''                         # gsutil bucket: per-epoch
    name: str = ''                           # results upload needs both
    tb_logdir: str = ''                      # TensorBoard logdir ('' = off)
    tp: int = 1
    device_mesh: Any = None                  # None: a mesh over a job of
                                             # several ranks; False: none
                                             # (one process); or a Mesh
    max_targets: int = 0
    image_weights: bool = False
    hyp_path: str | None = None
    hyp_override: dict | None = None
    seed: int = 0
    log_fn: Any = print
    n_burn_override: int | None = None       # None: max(3 * nb, 500)
    augment: bool = True
    resume: bool = False
    device_aug: bool = False
    cutout: bool = False
    ud_flip: bool = False
    accumulate_override: int | None = None   # None: the 64 / bs rule
    remat: str = 'none'
    float_dtype: str = 'bf16'                # conv compute dtype: 'bf16' or 'f32'
    qat_dtype: str = 'bf16'                  # QAT conv compute dtype: 'bf16' or 'f32'
    qat_bn_fast: bool = True                 # drop the BN statistics conv
                                             # after bn_freeze_step
    device: str = 'cuda'


def _check_options(opt: TrainOptions):
    if opt.augment and opt.device_aug:
        if opt.maxabsscaler:
            raise ValueError('--device-aug works on [0, 1] inputs: no '
                             '--maxabsscaler')
        if opt.rect:
            raise ValueError('--device-aug needs square letterboxed '
                             'batches: no --rect')


def resize_batch(x, size: int):
    """An NHWC f32 batch resized to ``size`` x ``size``: bilinear,
    half-pixel centres, with antialiasing when it shrinks, as
    ``jax.image.resize(..., 'bilinear')`` does."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode='bilinear', align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def _restore(ts, ck, net, log):
    """Optimizer state and EMA (with its counter) from a checkpoint."""
    if ck.get('opt_state') is not None:
        try:
            ts.optimizer.load_state_tree(opt_state_from_jax(net,
                                                            ck['opt_state']))
        except (KeyError, ValueError) as e:
            log(f'optimizer state not restored: {e!r}')
    if ck.get('ema') is not None and ts.ema is not None:
        ema_p, ema_s = from_jax(net, ck['ema'], ck.get('ema_state') or {})
        with torch.no_grad():
            for k, d in ema_p.items():
                for f, t in d.items():
                    if k in ts.ema.params and f in ts.ema.params[k]:
                        ts.ema.params[k][f].copy_(t)
            for k, d in ema_s.items():
                for f, t in d.items():
                    if k in ts.ema.state and f in ts.ema.state[k]:
                        ts.ema.state[k][f].copy_(t)
            ts.ema.updates.fill_(int(ck.get('ema_updates', 0)))


def run_training(opt: TrainOptions):
    """Train as the JAX package's ``run_training`` does; returns the last
    epoch's (P, R, mAP@0.5, F1, val lbox, lobj, lcls)."""
    _check_options(opt)
    device = torch.device(opt.device)
    cuda = device.type == 'cuda'
    log = opt.log_fn
    # a job of several processes: each rank feeds its shard of the global
    # batch through the data-parallel step
    pc, pi = process_count(), process_index()
    multihost = pc > 1
    if multihost:
        if opt.rect or opt.image_weights:
            raise ValueError('training across processes uses the plain '
                             'shuffled sampler: no --rect, no image weights')
        if opt.device_mesh is False:
            raise ValueError('training across processes needs the mesh (no '
                             '--no-mesh)')
    mesh = opt.device_mesh or None
    if mesh is None and multihost:
        mesh = make_mesh(device, model_parallel=opt.tp)
    # the data axis splits the batch; the ranks of a model axis share rows
    dp, di = (1, 0) if mesh is None else (mesh.shape[DATA_AXIS],
                                          mesh.data_index)
    tp = 1 if mesh is None else mesh.shape[MODEL_AXIS]
    if opt.batch_size % dp:
        raise ValueError(f'--batch-size {opt.batch_size} does not split '
                         f'over a data axis of {dp}')
    local_bs = opt.batch_size // dp
    is_chief = pi == 0
    hyp = load_hyp(opt.hyp_path)
    if opt.hyp_override:
        hyp.update(opt.hyp_override)
    data_dict = parse_data_cfg(opt.data)
    train_path = data_dict['train']
    nc = 1 if opt.single_cls else int(data_dict['classes'])

    imgsz_min, imgsz_max, imgsz_test = opt.img_size
    gs = 32
    if imgsz_min % gs:
        raise ValueError(f'--img-size {imgsz_min} is not a multiple of {gs}')
    multi_scale = opt.multi_scale or (imgsz_min != imgsz_max)
    if multi_scale and imgsz_min == imgsz_max:
        imgsz_min, imgsz_max = int(imgsz_min // 1.5), int(imgsz_max // 0.667)
    grid_min, grid_max = imgsz_min // gs, imgsz_max // gs
    imgsz_min, imgsz_max = grid_min * gs, grid_max * gs
    img_size = imgsz_max

    with open(train_path) as f:
        n_train = sum(1 for _ in f)
    steps = -(-n_train // opt.batch_size) * opt.epochs
    quant = opt.quantized != -1

    # --resume continues the raw trajectory; plain --weights fine-tunes from
    # the EMA pair, the deployable weights
    float_dtype = torch.float32 if opt.float_dtype == 'f32' else torch.bfloat16
    bundle = load_model(opt.cfg, opt.weights, device=device,
                        dtype=float_dtype, is_gray_scale=opt.gray_scale,
                        maxabsscaler=opt.maxabsscaler, pt=opt.pt,
                        prefer_ema=not opt.resume, quantized=opt.quantized,
                        a_bit=opt.a_bit, w_bit=opt.w_bit,
                        shortcut_way=opt.shortcut_way, steps=steps)
    net = bundle.net
    if opt.quantized == 2 and all(
            float(v[f]) == 1.0 for v in bundle.params.values()
            if 'a_scale' in v for f in ('a_scale', 'w_scale', 'b_scale')):
        # TPSQ's scales start from the search on one train batch; trained
        # ones (a fine-tune, a resume) stay
        cb = min(opt.batch_size, n_train)
        calib = DetectionDataset(train_path, img_size, cb, subset_len=cb,
                                 seed=opt.seed, is_gray_scale=opt.gray_scale)
        imgs = next(iter(BatchLoader(calib, cb)))[0]
        bundle.params = tpsq_warmup(
            net, bundle.qcfg, bundle.params, bundle.state, bundle.qstate,
            preprocess(imgs, opt.maxabsscaler, device=device))
    anchor_vecs = [np.asarray(l.anchors) / l.yolo_stride
                   for l in net.layers if l.kind == 'yolo']
    loss_hyp = LossHyp.from_dict(hyp, nc=nc)

    # the BN-gamma L1 term of sparse training: 0 normal sets, 1 shortcut
    # sets, 2 the CBLs before the shortcuts
    sparse_layers: tuple[int, ...] = ()
    if opt.prune == 0:
        sparse_layers = tuple(prunable_sets_normal(net).prune_idx)
    elif opt.prune == 1:
        sparse_layers = tuple(prunable_sets_shortcut(net).prune_idx)
    elif opt.prune == 2:
        sparse_layers = tuple(prunable_sets_layer(net)[2])

    # the heads' layout for the loss and the KD gathers: NHWC (a free
    # reshape of the head conv) but for KD6, whose rows group anchor-major
    train_layout = ('anchor_major' if opt.t_cfg and opt.kd_strategy == 6
                    else 'nhwc')
    kd_fn = None
    if opt.t_cfg:
        # the teacher: bf16, unfused, its BN on batch statistics in each
        # step (kd.make_kd_loss_fn)
        teacher = load_model(opt.t_cfg, opt.t_weights, device=device,
                             dtype=torch.bfloat16).model()
        kd_fn = make_kd_loss_fn(opt.kd_strategy, teacher, nc, anchor_vecs,
                                img_size=img_size, strides=bundle.strides,
                                kd5_mask=opt.kd5_mask, layout=train_layout)

    # QAT: the quant apply in train mode, bf16 MACs and bf16 eval snaps
    # (qat_dtype 'bf16') or f32 all through
    quant_apply = None
    if quant:
        qat_bf16 = opt.qat_dtype != 'f32'
        quant_apply = make_quant_apply(
            net, bundle.qcfg,
            compute_dtype=torch.bfloat16 if qat_bf16 else None,
            eval_snap_dtype=torch.bfloat16 if qat_bf16 else None,
            head_layout=train_layout)
    use_adam = opt.adam or quant
    fn_kw = dict(sparsity_s=opt.sparsity if opt.prune != -1 else 0.0,
                 sparse_gamma_layers=sparse_layers, kd_loss_fn=kd_fn,
                 mesh=mesh, remat=opt.remat)
    grad_fn, update_fn = make_train_functions(
        net, anchor_vecs, nc, loss_hyp, quant_apply=quant_apply, **fn_kw)
    # after bn_freeze_step the step without the BN statistics conv
    grad_fn_frozen, freeze_at, qat_steps = None, None, 0
    if quant and opt.qat_bn_fast and bundle.qcfg.bn_freeze_step > 0:
        freeze_at = bundle.qcfg.bn_freeze_step
        qat_steps = max((int(float(v['step'])) for v in bundle.qstate.values()
                         if 'step' in v), default=0)
        grad_fn_frozen, _ = make_train_functions(
            net, anchor_vecs, nc, loss_hyp,
            quant_apply=quant_apply.make_bn_frozen(), **fn_kw)
    ts = init_train_state(net, bundle.params, bundle.state,
                          optimizer='adam' if use_adam else 'sgd',
                          use_ema=opt.ema,
                          compute_dtype=(None if opt.float_dtype == 'f32'
                                         else float_dtype),
                          maxabsscaler=opt.maxabsscaler, device=device,
                          qstate=bundle.qstate)
    del bundle

    start_epoch, resume_best, resume_results = 0, 0.0, ''
    if opt.resume and opt.weights and str(opt.weights).endswith('.npz') and \
            os.path.exists(opt.weights):
        ck = load_checkpoint(opt.weights)
        if ck.get('epoch', -1) >= 0:
            start_epoch = int(ck['epoch']) + 1
            resume_best = float(ck.get('best_fitness', 0.0))
            resume_results = ck.get('training_results', '')
        _restore(ts, ck, net, log)
    if mesh is not None:
        # every rank starts from rank 0's state, split over the model axis
        shard_state(mesh, net, ts)

    dataset = DetectionDataset(
        train_path, img_size, local_bs,
        augment=opt.augment and not opt.device_aug, hyp=hyp, rect=opt.rect,
        cache_images=opt.cache_images, is_gray_scale=opt.gray_scale,
        image_weights=opt.image_weights, seed=opt.seed, cutout=opt.cutout,
        ud_flip=opt.ud_flip, process_shard=(di, dp) if multihost else None)
    dev_aug = None
    if opt.augment and opt.device_aug:
        dev_aug = make_device_augment(img_size, hyp, mosaic=True)
        aug_gen = torch.Generator(device=device)
    # each rank holds its block's share of the target capacity
    local_max_t = (opt.max_targets // dp if opt.max_targets
                   else 30 * local_bs)
    loader = BatchLoader(dataset, local_bs, max_targets=local_max_t,
                         shuffle=True, drop_last=True, seed=opt.seed)

    tb = None
    if opt.tb_logdir and is_chief:
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(opt.tb_logdir)
        except ImportError:
            log('tensorboardX unavailable; TB logging disabled')

    def upload(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if cuda else t

    def gather_rows(a):
        """Every data index's block (the first rank of each model axis)."""
        return allgather_host_values(a)[::tp]

    nb = len(loader)
    n_burn = (opt.n_burn_override if opt.n_burn_override is not None
              else max(3 * nb, 500))
    os.makedirs(opt.weights_dir, exist_ok=True)
    last = os.path.join(opt.weights_dir, 'last.npz')
    best = os.path.join(opt.weights_dir, 'best.npz')
    results = (0, 0, 0, 0, 0, 0, 0)
    best_fitness = resume_best
    if resume_results and start_epoch > 0 and is_chief:
        Path(opt.results_file).write_text(resume_results)
    maps = np.zeros(nc)
    t0 = time.time()
    rnd = random.Random(opt.seed)

    log(f'Image sizes {imgsz_min} - {imgsz_max} train, {imgsz_test} test')
    log(f'Starting training for {opt.epochs} epochs '
        f'({nb} batches/epoch, burn-in {n_burn})...')

    ni = start_epoch * nb
    loss_scale = opt.batch_size / 64.0
    for epoch in range(start_epoch, opt.epochs):
        if dataset.image_weights:
            dataset.update_image_weights(nc, maps)
        mloss_dev = torch.zeros(4, device=device)
        mloss = np.zeros(4)
        log_every = max(nb // 10, 1)
        cur_size = img_size
        for i, (imgs, tgt, valid, paths, _shapes) in enumerate(loader):
            ni = i + nb * epoch
            scalars, gr, accumulate = burn_in_scalars(
                ni, n_burn, epoch, lr0=hyp['lr0'], momentum=hyp['momentum'],
                weight_decay=hyp['weight_decay'], epochs=opt.epochs,
                batch_size=opt.batch_size, quantized=quant, adam=opt.adam)
            if opt.accumulate_override is not None:
                accumulate = opt.accumulate_override

            if ni == 0 and not opt.nosave and is_chief:
                try:
                    from ..utils.plots import plot_images
                    plot_images(imgs, np.asarray(tgt)[np.asarray(valid)],
                                paths=paths, fname='train_batch0.jpg')
                except Exception as e:     # a plot must never stop training
                    log(f'first-batch plot failed: {e}')

            if dev_aug is not None and multihost:
                # the global batch (rank-major, image indices shifted), one
                # augmentation of it on every rank, then this rank's rows
                g = np.array(tgt, np.float32)
                g[:, 0] += di * local_bs
                x = preprocess(upload(gather_rows(imgs).reshape(
                    -1, *imgs.shape[1:])), opt.maxabsscaler, device=device)
                aug_gen.manual_seed(opt.seed * 100003 + ni)
                x, tgt_in, valid_in = dev_aug(
                    x, upload(gather_rows(g).reshape(-1, 6)),
                    upload(gather_rows(np.asarray(valid, bool))
                           .reshape(-1)), aug_gen)
                x, tgt_in, valid_in = rows_of(x, tgt_in, valid_in,
                                              di * local_bs, local_bs)
            else:
                x = preprocess(upload(imgs), opt.maxabsscaler, device=device)
                tgt_in = upload(np.asarray(tgt, np.float32))
                valid_in = upload(np.asarray(valid, bool))
                if dev_aug is not None:
                    aug_gen.manual_seed(opt.seed * 100003 + ni)
                    x, tgt_in, valid_in = dev_aug(x, tgt_in, valid_in,
                                                  aug_gen)
            if multi_scale:
                # a new size every ``accumulate`` batches
                if (ni / max(accumulate, 1)) % 1 == 0:
                    cur_size = rnd.randrange(grid_min, grid_max + 1) * gs
                if cur_size != x.shape[1]:
                    x = resize_batch(x, cur_size)
            step_fn = (grad_fn_frozen if grad_fn_frozen is not None
                       and qat_steps >= freeze_at else grad_fn)
            ts, items = step_fn(ts, x, tgt_in, valid_in, gr, loss_scale)
            qat_steps += 1
            # the optimizer steps when ni % accumulate == 0, not every
            # accumulate-th batch since the last step (they differ while
            # accumulate ramps up in the burn-in)
            if ni % max(accumulate, 1) == 0:
                ts = update_fn(ts, scalars)
            mloss_dev = (mloss_dev * i + items) / (i + 1)
            if i % log_every == 0 or i + 1 == nb:
                # the ranks' shares sum to the global batch's losses
                mloss = all_reduce_nograd(
                    mloss_dev, None if mesh is None else mesh.data_group
                ).cpu().numpy()
                if not np.isfinite(mloss).all():
                    log(f'WARNING: non-finite loss, ending training {mloss}')
                    return results
                log(f'  epoch {epoch}/{opt.epochs - 1} batch {i}/{nb} '
                    f'giou {mloss[0]:.3g} obj {mloss[1]:.3g} '
                    f'cls {mloss[2]:.3g} total {mloss[3]:.3g} '
                    f'targets {int(np.asarray(valid).sum())} size {cur_size}')

        # epoch end: evaluate the EMA pair, results.txt, checkpoints
        final_epoch = epoch + 1 == opt.epochs
        use_ema = opt.ema and ts.ema is not None
        eval_params = ts.ema.params if use_ema else ts.params
        eval_state = ts.ema.state if use_ema else ts.bn_state
        if not opt.notest or final_epoch:
            # every data index evaluates its shard; the batch splits over
            # the data axis
            eval_bs = -(-max(opt.batch_size // 4, 1) // dp) * dp
            results, maps, _ = evaluate(
                net, eval_params, eval_state, opt.data,
                batch_size=eval_bs, img_size=imgsz_test,
                is_gray_scale=opt.gray_scale, multi_label=ni > n_burn,
                maxabsscaler=opt.maxabsscaler, single_cls=opt.single_cls,
                quant_apply=quant_apply, qstate=ts.qstate,
                loss_hyp=loss_hyp, anchor_vecs=anchor_vecs,
                plot=not opt.nosave, device=device, mesh=mesh)

        if tb is not None:
            tags = ['train/giou_loss', 'train/obj_loss', 'train/cls_loss',
                    'metrics/precision', 'metrics/recall', 'metrics/mAP_0.5',
                    'metrics/F1', 'val/giou_loss', 'val/obj_loss',
                    'val/cls_loss']
            for v, tag in zip(list(mloss[:3]) + list(results), tags):
                tb.add_scalar(tag, float(v), epoch)
            if opt.prune != -1 and sparse_layers:
                gammas = np.concatenate([
                    ts.params[str(i)]['gamma'].detach().abs().cpu().numpy()
                    for i in sparse_layers])
                tb.add_histogram('bn_weights/hist', gammas, epoch,
                                 bins='doane')

        fi = float(fitness(np.array(results).reshape(1, -1))[0])
        if fi > best_fitness:
            best_fitness = fi
        if is_chief:
            with open(opt.results_file, 'a') as f:
                f.write(('%10.4g' * 12 + '\n') % (epoch, *mloss, *results))
            if opt.bucket and opt.name:
                gsutil.sync_results(opt.bucket, opt.name, opt.results_file)
        if not opt.nosave and (is_chief or tp > 1):
            # under a model axis every rank: it gathers the split tensors
            save_train_checkpoint(
                last, ts, net, epoch=epoch, best_fitness=best_fitness,
                results_file=opt.results_file, with_opt=not final_epoch,
                mesh=mesh)
            if best_fitness == fi and not final_epoch:
                save_train_checkpoint(
                    best, ts, net, epoch=epoch, best_fitness=best_fitness,
                    results_file=opt.results_file, with_opt=False, mesh=mesh)

    if opt.bucket and not opt.nosave and is_chief:
        for ck in (last, best):
            if os.path.exists(ck):
                gsutil.upload_weights(opt.bucket, ck)
    log(f'{opt.epochs} epochs completed in {(time.time() - t0) / 3600:.3f} '
        f'hours.')
    return results


def save_train_checkpoint(path, ts, net, *, epoch: int, best_fitness: float,
                          results_file: str, with_opt: bool, mesh=None):
    """``last.npz``/``best.npz`` in the JAX package's layout: the raw
    params/state pair (for a resume), the EMA pair and its update count
    (what ``load_model`` serves), the quantizer state of a QAT run, and the
    optimizer state when ``with_opt``. Under a ``mesh`` with a model axis
    every rank calls this (the split tensors are gathered whole over the
    model group); rank 0 alone writes."""
    whole = lambda tree: gather_state(mesh, net, tree)
    params, state = whole(ts.params), whole(ts.bn_state)
    ema_pair = None if ts.ema is None else (whole(ts.ema.params),
                                            whole(ts.ema.state))
    opt_tree = None
    if with_opt:
        opt_tree = {n: whole(t) if isinstance(t, dict) else t
                    for n, t in ts.opt_state.items()}
    if process_index() != 0:
        return
    training_results = Path(results_file).read_text() \
        if os.path.exists(results_file) else ''
    params, state = to_jax(net, params, state)
    ema = ema_state = extra = None
    if ema_pair is not None:
        ema, ema_state = to_jax(net, *ema_pair)
        extra = {'ema_updates': int(ts.ema.updates)}
    save_checkpoint(path, params=params, state=state, epoch=epoch,
                    best_fitness=best_fitness,
                    training_results=training_results,
                    opt_state=(opt_state_to_jax(net, opt_tree)
                               if with_opt else None),
                    ema=ema, ema_state=ema_state, extra=extra,
                    qstate=(None if ts.qstate is None
                            else qstate_to_jax(ts.qstate)))
