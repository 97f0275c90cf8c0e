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

Not ported (see ROADMAP.md): quantized training (QAT), knowledge
distillation, the device augmentations, the gsutil bucket upload, tensor
parallelism and multi-host training; they raise ``NotImplementedError``.
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
from ..compress.quant import unported
from ..config import load_hyp, parse_data_cfg
from ..convert import from_jax, opt_state_from_jax, opt_state_to_jax, to_jax
from ..data.datasets import BatchLoader, DetectionDataset
from ..eval.evaluator import evaluate
from ..eval.metrics import fitness
from ..runtime import load_model, preprocess
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .loss import LossHyp
from .schedules import burn_in_scalars
from .trainer import init_train_state, make_train_functions


@dataclass
class TrainOptions:
    """The training flags (the JAX package's ``TrainOptions``, less its
    mesh and the settings of the unported QAT and KD paths, plus
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
    maxabsscaler: bool = False
    gray_scale: bool = False
    pt: bool = False
    t_cfg: str = ''                          # teacher cfg (KD)
    notest: bool = False
    nosave: bool = False
    weights_dir: str = 'weights'
    results_file: str = 'results.txt'
    bucket: str = ''
    tb_logdir: str = ''                      # TensorBoard logdir ('' = off)
    tp: int = 1
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
    device: str = 'cuda'


def _check_ported(opt: TrainOptions):
    if opt.quantized != -1:
        raise unported(f'quantized training (--quantized {opt.quantized})')
    if opt.t_cfg:
        raise unported('knowledge distillation (--t_cfg)')
    if opt.device_aug:
        raise unported('the device augmentations (--device-aug)')
    if opt.bucket:
        raise unported('the gsutil bucket upload (--bucket)')
    if opt.tp > 1:
        raise unported(f'tensor parallelism (--tp {opt.tp})')
    if opt.remat not in ('none', ''):
        raise unported(f'--remat {opt.remat}')


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
    _check_ported(opt)
    device = torch.device(opt.device)
    cuda = device.type == 'cuda'
    log = opt.log_fn
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

    # --resume continues the raw trajectory; plain --weights fine-tunes from
    # the EMA pair, the deployable weights
    float_dtype = torch.float32 if opt.float_dtype == 'f32' else torch.bfloat16
    bundle = load_model(opt.cfg, opt.weights, device=device,
                        dtype=float_dtype, is_gray_scale=opt.gray_scale,
                        maxabsscaler=opt.maxabsscaler, pt=opt.pt,
                        prefer_ema=not opt.resume)
    net = bundle.net
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

    grad_fn, update_fn = make_train_functions(
        net, anchor_vecs, nc, loss_hyp,
        sparsity_s=opt.sparsity if opt.prune != -1 else 0.0,
        sparse_gamma_layers=sparse_layers)
    ts = init_train_state(net, bundle.params, bundle.state,
                          optimizer='adam' if opt.adam else 'sgd',
                          use_ema=opt.ema,
                          compute_dtype=(None if opt.float_dtype == 'f32'
                                         else float_dtype),
                          maxabsscaler=opt.maxabsscaler, device=device)
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

    dataset = DetectionDataset(
        train_path, img_size, opt.batch_size, augment=opt.augment, hyp=hyp,
        rect=opt.rect, cache_images=opt.cache_images,
        is_gray_scale=opt.gray_scale, image_weights=opt.image_weights,
        seed=opt.seed, cutout=opt.cutout, ud_flip=opt.ud_flip)
    loader = BatchLoader(dataset, opt.batch_size,
                         max_targets=opt.max_targets or 30 * opt.batch_size,
                         shuffle=True, drop_last=True, seed=opt.seed)

    tb = None
    if opt.tb_logdir:
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(opt.tb_logdir)
        except ImportError:
            log('tensorboardX unavailable; TB logging disabled')

    def upload(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if cuda else t

    nb = len(loader)
    n_burn = (opt.n_burn_override if opt.n_burn_override is not None
              else max(3 * nb, 500))
    os.makedirs(opt.weights_dir, exist_ok=True)
    last = os.path.join(opt.weights_dir, 'last.npz')
    best = os.path.join(opt.weights_dir, 'best.npz')
    results = (0, 0, 0, 0, 0, 0, 0)
    best_fitness = resume_best
    if resume_results and start_epoch > 0:
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
                batch_size=opt.batch_size, adam=opt.adam)
            if opt.accumulate_override is not None:
                accumulate = opt.accumulate_override

            if ni == 0 and not opt.nosave:
                try:
                    from ..utils.plots import plot_images
                    plot_images(imgs, np.asarray(tgt)[np.asarray(valid)],
                                paths=paths, fname='train_batch0.jpg')
                except Exception as e:     # a plot must never stop training
                    log(f'first-batch plot failed: {e}')

            x = preprocess(upload(imgs), opt.maxabsscaler, device=device)
            if multi_scale:
                # a new size every ``accumulate`` batches
                if (ni / max(accumulate, 1)) % 1 == 0:
                    cur_size = rnd.randrange(grid_min, grid_max + 1) * gs
                if cur_size != x.shape[1]:
                    x = resize_batch(x, cur_size)
            ts, items = grad_fn(ts, x, upload(np.asarray(tgt, np.float32)),
                                upload(np.asarray(valid, bool)), gr,
                                loss_scale)
            # the optimizer steps when ni % accumulate == 0, not every
            # accumulate-th batch since the last step (they differ while
            # accumulate ramps up in the burn-in)
            if ni % max(accumulate, 1) == 0:
                ts = update_fn(ts, scalars)
            mloss_dev = (mloss_dev * i + items) / (i + 1)
            if i % log_every == 0 or i + 1 == nb:
                mloss = mloss_dev.cpu().numpy()
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
            results, maps, _ = evaluate(
                net, eval_params, eval_state, opt.data,
                batch_size=max(opt.batch_size // 4, 1), img_size=imgsz_test,
                is_gray_scale=opt.gray_scale, multi_label=ni > n_burn,
                maxabsscaler=opt.maxabsscaler, single_cls=opt.single_cls,
                loss_hyp=loss_hyp, anchor_vecs=anchor_vecs,
                plot=not opt.nosave, device=device)

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

        with open(opt.results_file, 'a') as f:
            f.write(('%10.4g' * 12 + '\n') % (epoch, *mloss, *results))

        fi = float(fitness(np.array(results).reshape(1, -1))[0])
        if fi > best_fitness:
            best_fitness = fi
        if not opt.nosave:
            save_train_checkpoint(
                last, ts, net, epoch=epoch, best_fitness=best_fitness,
                results_file=opt.results_file, with_opt=not final_epoch)
            if best_fitness == fi and not final_epoch:
                save_train_checkpoint(
                    best, ts, net, epoch=epoch, best_fitness=best_fitness,
                    results_file=opt.results_file, with_opt=False)

    log(f'{opt.epochs} epochs completed in {(time.time() - t0) / 3600:.3f} '
        f'hours.')
    return results


def save_train_checkpoint(path, ts, net, *, epoch: int, best_fitness: float,
                          results_file: str, with_opt: bool):
    """``last.npz``/``best.npz`` in the JAX package's layout: the raw
    params/state pair (for a resume), the EMA pair and its update count
    (what ``load_model`` serves), and the optimizer state when
    ``with_opt``."""
    training_results = Path(results_file).read_text() \
        if os.path.exists(results_file) else ''
    params, state = to_jax(net, ts.params, ts.bn_state)
    ema = ema_state = extra = None
    if ts.ema is not None:
        ema, ema_state = to_jax(net, ts.ema.params, ts.ema.state)
        extra = {'ema_updates': int(ts.ema.updates)}
    save_checkpoint(path, params=params, state=state, epoch=epoch,
                    best_fitness=best_fitness,
                    training_results=training_results,
                    opt_state=(opt_state_to_jax(net, ts.opt_state)
                               if with_opt else None),
                    ema=ema, ema_state=ema_state, extra=extra)
