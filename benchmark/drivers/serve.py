"""Serving: one client in a closed loop over a pool of seeded batches.

Each step takes a uint8 NHWC batch from host memory, as a decoder hands
it over, through ``yolo_tpu_torch.runtime.preprocess``, the callable of
``ModelBundle.make_infer`` and ``ops.nms.to_host_detections``; the next
batch starts once the last one's detections are on the host.

Forms: ``int8`` (the configuration's quantization scheme calibrated on
the pool's first batches, served by the int8 engine) and ``bf16`` (the
BN-folded float model; its BN statistics are one pool batch's, worked out
by the reference). The check runs the reference on a sample of the served
batches, drawn from the seed, and holds the served detections to it
(``benchmark/compare.py``).

Faults (tests and controls): ``half`` serves no detections for the second
half of each batch, ``alter`` shifts every detection's class by one (an
off-by-one in the class index), ``scale`` serves every score halved,
``control`` serves the reference at the
precision below the configuration's (int4 for int8, float8 for bf16) in
the program's place.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, counts, inputs
from benchmark.common import Context, cfg_path, fp8, nchw, sync
from benchmark.reference import darknet, detect

RANGES = ('preprocess', 'infer', 'to_host')


class State:
    pass


def reference_heads(s, bits, cast=None):
    """The reference's head maps of an NCHW batch: the configuration's
    form at ``bits`` (int8 forms; the calibration replayed on the same
    batches), or the float forward under ``cast``."""
    form = s.form
    if s.quant:
        sim = darknet.QuantSim(s.layers, s.params, s.zero_state,
                               form['scheme'], bits, form['steps'], s.dev)
        for c in range(form['calibration_batches']):
            sim.calibrate(s.batch(c))
        return sim.heads
    return lambda x: darknet.forward(s.layers, s.params, s.state, x, cast)


def reference_dets(s, heads_fn, x):
    """The reference's detections of each image of x."""
    wl = s.wl
    boxes, obj, scores, sizes = detect.decode(heads_fn(x), s.layers, s.size)
    rule = 'cells' if s.quant else 'boxes'
    return [detect.nms(boxes[j], scores[j],
                       detect.candidates(obj[j], sizes, wl['conf_thres'],
                                         wl['top_k'], rule),
                       wl['conf_thres'], wl['iou_thres'], wl['top_k'],
                       wl['max_det'])
            for j in range(len(x))]


def setup(ctx: Context):
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.ops.nms import to_host_detections
    s = State()
    s.ctx, s.wl, s.dev = ctx, ctx.workload, ctx.device
    cf = ctx.config
    s.form = cf['forms'][s.wl['form']]
    s.quant = 'scheme' in s.form
    s.layers = darknet.build(cf['darknet_cfg'])
    s.size, s.bs, n_pool = cf['img_size'], s.wl['batch'], s.wl['pool']
    s.params, state = inputs.weights(s.layers, ctx.seed, s.form['init'],
                                     s.dev)
    pool = inputs.images(ctx.seed, n_pool * s.bs, s.size, s.dev)
    s.pool = pool.cpu().numpy().reshape(n_pool, s.bs, s.size, s.size, 3)
    s.batch = lambda k: nchw(torch.from_numpy(s.pool[k]).to(s.dev))
    s.zero_state = {k: {f: torch.zeros_like(t) for f, t in d.items()}
                    for k, d in state.items()}
    if not s.quant:
        state = darknet.batch_statistics(s.layers, s.params, nchw(pool[:s.bs]))
    s.state = state
    del pool
    kw = {k: s.wl[k] for k in ('conf_thres', 'iou_thres', 'top_k', 'max_det')}
    path = cfg_path(ctx)
    if ctx.fault == 'control':
        s.bundle = None
        low = reference_heads(s, 4, None if s.quant else fp8)

        def infer(x):
            dets = reference_dets(s, low, x.permute(0, 3, 1, 2))
            out = torch.zeros((len(x), kw['max_det'], 6), device=s.dev)
            for j, d in enumerate(dets):
                out[j, :len(d)] = d
            return out
    elif s.quant:
        b = runtime.load_model(path, device=s.dev,
                               quantized=s.form['quantized'],
                               a_bit=s.form['bits'], w_bit=s.form['bits'],
                               steps=s.form['steps'])
        b.params = {k: {**b.params[k], **_clone(v)}
                    for k, v in s.params.items()}
        b.state = {k: _clone(v) for k, v in s.zero_state.items()}
        for c in range(s.form['calibration_batches']):
            b.apply(runtime.preprocess(s.pool[c], device=s.dev), train=True)
        s.bundle = b
        infer = b.make_infer(**kw)
    else:
        b = runtime.load_model(path, device=s.dev)
        b.params = {k: _clone(v) for k, v in s.params.items()}
        b.state = {k: _clone(v) for k, v in s.state.items()}
        s.bundle = b.fuse()
        infer = s.bundle.make_infer(**kw)
    s.infer = _broken(infer, ctx.fault, s.layers[-1].nc)
    s.preprocess, s.to_host = runtime.preprocess, to_host_detections
    s.served = []
    for k in range(s.wl['warmup_batches']):
        _serve(s, k)
    s.served.clear()
    return s


def _clone(d):
    return {f: t.clone() for f, t in d.items()}


def _broken(infer, fault, nc):
    if fault not in ('half', 'alter', 'scale'):
        return infer

    def broken(x):
        dets = infer(x).clone()
        if fault == 'half':
            dets[len(dets) // 2:] = 0
        elif fault == 'scale':
            dets[..., 4] *= 0.5
        else:
            dets[..., 5] = (dets[..., 5] + 1) % nc
        return dets
    return broken


def _serve(s, k):
    with record_function('preprocess'):
        x = s.preprocess(s.pool[k], device=s.dev)
    with record_function('infer'):
        dets = s.infer(x)
    with record_function('to_host'):
        out = s.to_host(dets)
    s.served.append((k, out))


def step(s, i):
    _serve(s, i % len(s.pool))
    return s.bs


def finish(s):
    sync(s.dev)


def end_to_end(window):
    lat_ms = sorted(t * 1e3 for t in window['latency_s'])
    return {'images_per_s': window['items'] / window['seconds'],
            'batch_ms_p95': float(np.percentile(lat_ms, 95)),
            'setup_s': window['setup_s']}


def record(s, window):
    convs = darknet.macs(s.layers, s.size)
    return {'driver': 'serve', 'form': s.wl['form'], 'bs': s.bs,
            'conv_ops': counts.conv_ops(convs, s.bs),
            'peak_ops_per_s': (counts.INT8_OPS_PER_S if s.quant
                               else counts.BF16_OPS_PER_S),
            'k2_bound_ms': (counts.k2_bound_ms(convs, s.layers, s.bs)
                            if s.quant else None),
            'grouped_bound_ms': (counts.grouped_bound_ms(convs, s.layers,
                                                         s.bs)
                                 if s.quant else None),
            # every candidate slot is valid at the traffic's conf_thres
            'k1_bound_ms': counts.k1_bound_ms(s.bs, s.wl['top_k'],
                                              [s.wl['top_k']] * s.bs)}


def check(s):
    """The served detections of a sample of the window's batches against
    the reference's, after the program is freed."""
    chk = s.wl['check']
    rng = np.random.default_rng([int(s.ctx.seed), 4])
    last = {k: out for k, out in s.served}        # each pool batch's last
    picks = rng.choice(sorted(last), min(chk['batches'], len(last)),
                       replace=False)
    s.bundle = s.infer = None
    s.served.clear()
    if s.dev.type == 'cuda':
        torch.cuda.empty_cache()
    heads_fn = reference_heads(s, s.form.get('bits', 32))
    served, want = [], []
    with torch.no_grad():
        for k in picks:
            served += last[int(k)]
            want += reference_dets(s, heads_fn, s.batch(int(k)))
        got = compare.detections(served, want, chk['top'],
                                 s.layers[-1].nc)
    return {n: (v, chk['limits'].get(n)) for n, v in got.items()}
