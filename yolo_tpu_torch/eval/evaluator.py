"""mAP evaluator (counterpart of yolo_tpu/eval/evaluator.py).

Device side, per batch: forward, decode and batched NMS (K1 suppression),
the TP matching (``matching.match_device``) and the val losses
(``train/loss.compute_loss``). Host side: the per-image bookkeeping, AP
accumulation in numpy, and the table the JAX package prints ('Class
Images Targets P R mAP@0.5 F1').

One-batch lookahead: eager PyTorch queues a batch's kernels and returns,
but reading a result to the host waits for everything queued before the
read, so a plain ``.cpu()`` of batch n queued behind batch n+1 would wait
for n+1 too. So right after batch n is queued, its outputs are copied
without blocking into pinned host buffers and an event is recorded; then
batch n+1 is uploaded (from pinned memory, without blocking) and queued,
and only then does the host wait, on batch n's event alone, and run batch
n's statistics while the device computes batch n+1. Nothing on the path
copies from pageable host memory or reads a device value, either of which
would synchronise the stream.

Not ported yet (see ROADMAP.md): test-time augmentation, mesh and
multi-process evaluation, the quantized apply's sparse twin
(``make_heads_only``) and ``prepare_eval_params``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..compress.quant import unported
from ..config import load_classes, parse_data_cfg
from ..data.datasets import BatchLoader, DetectionDataset
from ..models.network import Darknet
from ..models.yolo_head import reshape_pred
from ..ops.nms import (non_max_suppression, non_max_suppression_heads,
                       to_host_detections)
from ..runtime import preprocess
from ..train.loss import compute_loss
from .matching import match_device
from .metrics import ap_per_class, coco80_to_coco91_class, match_predictions

# What is costly to build and reused across evaluate() calls on the same
# weights: the eval-mode Darknet module (the params cast to the compute
# dtype, channels_last, on the device) and the int8 engine's plan.
# Keyed by object identity and the tensors' version counters (an in-place
# update of a weight misses the cache); the value keeps strong references
# so that the ids stay valid. Bounded: each entry holds a model's weights.
_CACHE: dict = {}
_CACHE_SIZE = 4


def _fingerprint(tree):
    if isinstance(tree, dict):
        return tuple((k, _fingerprint(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_fingerprint(v) for v in tree)
    if torch.is_tensor(tree):
        return (id(tree), 0 if tree.is_inference() else tree._version)
    return id(tree)


def _cached(key, refs, build):
    hit = _CACHE.get(key)
    if hit is not None:
        return hit[0]
    value = build()
    if len(_CACHE) >= _CACHE_SIZE:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = (value, refs)
    return value


def eval_model(net, params, state, *, fused, compute_dtype, maxabsscaler,
               device) -> Darknet:
    """The eval-mode ``Darknet`` of these weights on ``device`` (cached)."""
    device = torch.device(device)
    key = ('model', id(net), _fingerprint(params), _fingerprint(state), fused,
           compute_dtype, maxabsscaler, str(device))
    return _cached(key, (net, params, state), lambda: Darknet(
        net, params, state, fused=fused, maxabsscaler=maxabsscaler,
        dtype=compute_dtype).to(device, memory_format=torch.channels_last)
        .eval())


def int8_engine_apply(net, params, state, qstate, qcfg, device):
    """(plan arrays, quant apply) of the true-int8 engine for ``evaluate``,
    wired as the JAX package's ``test.py --int8-engine`` wires it: the
    engine's dense (io, yolo_p) output feeds the dense NMS, and every conv
    on an int8 edge runs K2. The ``prepare_int8`` plan is cached."""
    from ..models.int8_engine import make_int8_apply, prepare_int8
    key = ('int8', id(net), _fingerprint(params), _fingerprint(state),
           _fingerprint(qstate), qcfg, str(device))

    def build():
        plan = prepare_int8(net, params, state, qstate, qcfg, device=device)
        eng = make_int8_apply(net, plan)
        return plan.arrays, lambda pa, st, qs, x, train: (*eng(pa, x), [])
    return _cached(key, (net, params, state, qstate), build)


def _build_infer(net, params, state, qstate, *, quant_apply, anchor_vecs,
                 loss_hyp, want_loss, sparse, fused, compute_dtype,
                 maxabsscaler, conf_thres, iou_thres, top_k, max_det,
                 multi_label, iouv, device_match, nc, device):
    """The per-batch eval step: infer(x, targets, valid, img_w) ->
    (dets, val loss items (3,) or None, correct or None), all queued on
    ``device`` without a host synchronise."""
    nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres, top_k=top_k,
                  max_det=max_det, multi_label=multi_label)
    yolos = [l for l in net.layers if l.kind == 'yolo']
    layout = 'anchor_major'
    if quant_apply is not None:
        # the quantized sim or the int8 engine: dense io into the dense NMS
        layout = getattr(quant_apply, 'head_layout', layout)

        def fwd(x):
            io, yolo_p, _ = quant_apply(params, state, qstate, x, False)
            return non_max_suppression(io, **nms_kw), yolo_p
    else:
        model = eval_model(net, params, state, fused=fused,
                           compute_dtype=compute_dtype,
                           maxabsscaler=maxabsscaler, device=device)
        to_pred = lambda heads: [reshape_pred(h, l.na, l.no)
                                 for h, l in zip(heads, yolos)]
        if sparse:
            anchors = model.anchors()
            strides = [l.yolo_stride for l in yolos]

            def fwd(x):
                heads, objs = model.forward_heads(x)
                return non_max_suppression_heads(
                    heads, anchors, strides, yolos[0].no, objs=objs,
                    **nms_kw), to_pred(heads)
        else:
            def fwd(x):
                heads = model.heads(x)
                return non_max_suppression(model.decode(heads),
                                           **nms_kw), to_pred(heads)

    @torch.inference_mode()
    def infer(x, targets, valid, img_w):
        dets, yolo_p = fwd(x)
        correct = (match_device(dets, targets, valid, float(x.shape[2]),
                                float(x.shape[1]), iouv)
                   if device_match else None)
        items = None
        if want_loss:
            items = compute_loss([p.to(torch.float32) for p in yolo_p],
                                 targets, valid, anchor_vecs, nc, loss_hyp,
                                 1.0, layout=layout, img_weight=img_w)[1][:3]
        return dets, items, correct
    return infer


def _plot_eval_batch0(batch0, det_list, names):
    """GT-vs-pred mosaics of the first eval batch -> test_batch0_gt.jpg and
    test_batch0_pred.jpg (detections turned back into target rows)."""
    try:
        from ..utils.plots import plot_images
        imgs, tgt, valid, paths = batch0
        h, w = imgs.shape[1:3]
        plot_images(imgs, tgt[valid], paths=paths, names=names,
                    fname='test_batch0_gt.jpg')
        rows = []
        for si, pred in enumerate(det_list[:len(imgs)]):
            if pred is None:
                continue
            for x1, y1, x2, y2, _conf, cls in pred:
                rows.append([si, int(cls), (x1 + x2) / 2 / w,
                             (y1 + y2) / 2 / h, (x2 - x1) / w,
                             (y2 - y1) / h])
        plot_images(imgs, np.asarray(rows, np.float32).reshape(-1, 6),
                    paths=paths, names=names, fname='test_batch0_pred.jpg')
    except Exception as e:        # plotting must never fail an eval
        print(f'eval batch0 plot failed: {e!r}')


def _xywh2xyxy_np(x):
    y = np.copy(x)
    y[..., 0] = x[..., 0] - x[..., 2] / 2
    y[..., 1] = x[..., 1] - x[..., 3] / 2
    y[..., 2] = x[..., 0] + x[..., 2] / 2
    y[..., 3] = x[..., 1] + x[..., 3] / 2
    return y


def evaluate(net, params, state, data, *, batch_size=16, img_size=416,
             conf_thres=0.001, iou_thres=0.6, multi_label=True,
             compute_dtype=torch.bfloat16, fused=False, single_cls=False,
             is_gray_scale=False, save_json=False, verbose=False,
             max_det=300, top_k=512, iouv=(0.5,), dataset=None,
             maxabsscaler=False, loader=None, quant_apply=None, qstate=None,
             loss_hyp=None, anchor_vecs=None, sparse=False, augment=False,
             device_match=True, mesh=None, plot=False, device='cuda'):
    """Run mAP evaluation on ``device``. Returns ((mp, mr, map50, mf1,
    lbox, lobj, lcls), maps, (t_inf, t_nms)), as the JAX package does.

    ``net``: the ``NetworkIR``; ``params``/``state``: the port's dicts of
    tensors (``fused=True`` with the folded params and an empty state).
    ``data``: the .data file (classes, names, the ``valid`` list);
    ``loader``: any iterable of the ``BatchLoader`` tuple instead of the
    dataset it names.

    ``sparse``: the float path's sparse-decode NMS from the raw head maps;
    dense by default (faster on an H100, PERF.md). ``quant_apply`` (with
    ``qstate``): a quantized apply (params, state, qstate, x, train) ->
    (io, yolo_p, feats), the fake-quant sim (``make_quant_apply``) or the
    int8 engine (``int8_engine_apply``), always dense.

    ``loss_hyp`` with ``anchor_vecs`` (per-layer (na, 2) anchors / stride)
    adds the val losses; the ragged tail's pad slots weigh 0 in them.

    ``device_match``: the TP assignment runs on the device
    (``matching.match_device``) instead of the host loop
    (``metrics.match_predictions``); both give the same result.

    ``t_inf`` is the host's time to queue the batches and to wait for their
    results; ``t_nms`` is 0 (NMS runs inside the timed step), as in the JAX
    package."""
    if augment:
        raise unported('test-time augmentation (evaluate(augment=True))')
    if mesh is not None:
        raise unported('mesh and multi-process evaluation (the parallel/ '
                        'slice)')
    device = torch.device(device)
    cuda = device.type == 'cuda'
    data_dict = parse_data_cfg(data)
    nc = 1 if single_cls else int(data_dict['classes'])
    names = load_classes(data_dict['names'])
    iouv_t = tuple(float(v) for v in iouv)
    iouv = np.asarray(iouv, np.float64)
    niou = len(iouv)

    want_loss = loss_hyp is not None and anchor_vecs is not None
    if quant_apply is not None:
        sparse = False          # the port's quantized applies have no sparse twin
    avecs = ([torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in anchor_vecs] if want_loss else None)
    infer = _build_infer(
        net, params, state, qstate, quant_apply=quant_apply,
        anchor_vecs=avecs, loss_hyp=loss_hyp, want_loss=want_loss,
        sparse=sparse, fused=fused, compute_dtype=compute_dtype,
        maxabsscaler=maxabsscaler, conf_thres=conf_thres,
        iou_thres=iou_thres, top_k=top_k, max_det=max_det,
        multi_label=multi_label, iouv=iouv_t, device_match=device_match,
        nc=nc, device=device)

    if loader is None:
        if dataset is None:
            dataset = DetectionDataset(data_dict['valid'], img_size,
                                       batch_size, rect=True,
                                       is_gray_scale=is_gray_scale)
        loader = BatchLoader(dataset, batch_size)

    def upload(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if cuda else t

    def to_host(t):
        """A pinned host copy of ``t``, queued without blocking."""
        if not cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t, non_blocking=True)

    seen = 0
    stats = []
    jdict = []
    coco91 = coco80_to_coco91_class()
    t_inf = t_nms = 0.0
    plot_stash: dict = {}

    print(('%20s' + '%10s' * 6) % ('Class', 'Images', 'Targets', 'P', 'R',
                                   'mAP@0.5', 'F1'))
    val_loss = np.zeros(3)
    n_batches = 0

    def dispatch(batch):
        """Upload and queue one batch, then queue the copies of its outputs
        to the host; returns them with the event that marks their end."""
        imgs, tgt, valid, paths, shapes = batch
        if plot and 'batch0' not in plot_stash:
            plot_stash['batch0'] = (np.asarray(imgs), np.asarray(tgt),
                                    np.asarray(valid), list(paths))
        # ragged-tail pad slots (empty path) weigh 0 in the val losses
        real_w = np.array([bool(p) for p in paths], np.float32)
        x = preprocess(upload(imgs), maxabsscaler, device=device)
        outs = infer(x, upload(np.asarray(tgt, np.float32)),
                     upload(np.asarray(valid, bool)), upload(real_w))
        outs = tuple(None if t is None else to_host(t) for t in outs)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return outs, event, tgt, valid, paths, shapes, imgs.shape[1:3]

    it = iter(loader)
    pending = None
    while True:
        nxt = next(it, None)
        if nxt is not None:
            t0 = time.perf_counter()
            issued = dispatch(nxt)
            t_inf += time.perf_counter() - t0
        else:
            issued = None
        if pending is None:
            if issued is None:
                break
            pending = issued
            continue
        (dets, loss_items, correct_dev), event, tgt, valid, paths, shapes, \
            (h, w) = pending
        pending = issued
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()           # batch n only; n+1 keeps running
        dets_np = dets.numpy()
        det_list = to_host_detections(dets_np)
        correct_np = None if correct_dev is None else correct_dev.numpy()
        t_inf += time.perf_counter() - t0
        if loss_items is not None:
            val_loss += loss_items.numpy()
        n_batches += 1
        if plot and n_batches == 1:
            _plot_eval_batch0(plot_stash.pop('batch0'), det_list, names)

        tgt = np.asarray(tgt)[np.asarray(valid)]
        for si in range(len(paths)):
            if not paths[si]:
                continue  # ragged-batch padding
            labels = tgt[tgt[:, 0] == si, 1:]
            nl = len(labels)
            tcls = labels[:, 0].tolist() if nl else []
            seen += 1
            pred = det_list[si]
            if pred is None:
                if nl:
                    stats.append((np.zeros((0, niou), bool), np.zeros(0),
                                  np.zeros(0), tcls))
                continue
            pred = pred.copy()
            pred[:, [0, 2]] = pred[:, [0, 2]].clip(0, w)
            pred[:, [1, 3]] = pred[:, [1, 3]].clip(0, h)

            if save_json and shapes[si] is not None:
                (h0, w0), ((rh, rw), pad) = shapes[si]
                image_id = Path(paths[si]).stem.split('_')[-1]
                try:
                    image_id = int(image_id)
                except ValueError:
                    pass
                box = pred[:, :4].copy()
                box[:, [0, 2]] = (box[:, [0, 2]] - pad[0]) / rw
                box[:, [1, 3]] = (box[:, [1, 3]] - pad[1]) / rh
                box[:, 2:4] -= box[:, 0:2]  # xyxy -> xywh top-left
                for pr, b in zip(pred.tolist(), box.tolist()):
                    jdict.append({'image_id': image_id,
                                  'category_id': coco91[int(pr[5])]
                                  if nc == 80 else int(pr[5]),
                                  'bbox': [round(v, 3) for v in b],
                                  'score': round(pr[4], 5)})

            if correct_np is not None:
                # rows of correct align with the dets rows; keep the same
                # conf > 0 mask that to_host_detections applied
                keep = dets_np[si][:, 4] > 0
                correct = correct_np[si][keep]
            else:
                correct = np.zeros((len(pred), niou), bool)
                if nl:
                    tbox = _xywh2xyxy_np(labels[:, 1:5]) * [w, h, w, h]
                    correct = match_predictions(pred, labels[:, 0], tbox,
                                                iouv)
            stats.append((correct, pred[:, 4], pred[:, 5], tcls))

    mp = mr = map50 = mf1 = 0.0
    maps = np.zeros(nc)
    ap_class = []
    if stats:
        cat = [np.concatenate([np.atleast_1d(np.asarray(s[i])) for s in stats], 0)
               for i in range(3)]
        tcls_all = np.concatenate([np.asarray(s[3]) for s in stats]) \
            if any(len(s[3]) for s in stats) else np.zeros(0)
        if len(cat[0]):
            p, r, ap, f1, ap_class = ap_per_class(cat[0], cat[1], cat[2], tcls_all)
            if niou > 1:
                p, r, ap, f1 = p[:, 0], r[:, 0], ap.mean(1), ap[:, 0]
            else:
                p, r, ap, f1 = p[:, 0], r[:, 0], ap[:, 0], f1[:, 0]
            mp, mr, map50, mf1 = p.mean(), r.mean(), ap.mean(), f1.mean()
            for i, c in enumerate(ap_class):
                maps[c] = ap[i]

    nt = int(sum(len(s[3]) for s in stats))
    pf = '%20s' + '%10.3g' * 6
    print(pf % ('all', seen, nt, mp, mr, map50, mf1))
    if verbose and nc > 1 and len(ap_class):
        for i, c in enumerate(ap_class):
            n_c = int(sum(1 for s in stats for t in s[3] if t == c))
            print(pf % (names[c], seen, n_c, p[i], r[i], ap[i], f1[i]))

    if save_json and jdict:
        with open('results.json', 'w') as f:
            json.dump(jdict, f)
        try:
            from pycocotools.coco import COCO            # optional
            from pycocotools.cocoeval import COCOeval
            ann = glob_coco_annotations(data_dict)
            if ann:
                cocoGt = COCO(ann)
                cocoDt = cocoGt.loadRes('results.json')
                ev = COCOeval(cocoGt, cocoDt, 'bbox')
                ev.evaluate(); ev.accumulate(); ev.summarize()
                map50 = ev.stats[1]
        except ImportError:
            pass

    vl = val_loss / max(n_batches, 1)
    return (mp, mr, map50, mf1, float(vl[0]), float(vl[1]),
            float(vl[2])), maps, (t_inf, t_nms)


def glob_coco_annotations(data_dict):
    import glob as _g
    hits = _g.glob('**/instances_val*.json', recursive=True)
    return hits[0] if hits else None
