"""The plain reference against the port at a tiny size on the CPU
(yolov3-tiny, 96 px): the float forward, the google and cos-PTQ sims with
their calibration, the int8 engine's detections, and the train step in
f32. Where both sides compute the same arithmetic the two agree to
rounding; the int8 engine, whose sums are exact integers, is held by the
detection comparison the cells use."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import REPO, cfg_lines

from benchmark import compare, inputs
from benchmark.common import nchw
from benchmark.reference import darknet, detect, loss as ref_loss

CFG = os.path.join(REPO, 'cfg', 'yolov3tiny', 'yolov3-tiny.cfg')
SIZE, SEED = 96, 7
INIT = {'conv_scale': 1.5, 'bn_gamma': [0.18, 0.42], 'bn_beta_std': 0.5}
DEV = torch.device('cpu')


def reference_dets(heads, layers, rule='boxes'):
    boxes, obj, scores, sizes = detect.decode(heads, layers, SIZE)
    return [detect.nms(boxes[j], scores[j],
                       detect.candidates(obj[j], sizes, 0.001, 512, rule),
                       0.001, 0.6, 512, 300) for j in range(len(boxes))]


@pytest.fixture(scope='module')
def tiny():
    from yolo_tpu_torch.ir import build_ir
    layers = darknet.build(cfg_lines(CFG))
    imgs = inputs.images(SEED, 6, SIZE, DEV)
    return layers, build_ir(CFG), imgs


def test_float_heads_and_detections(tiny):
    from yolo_tpu_torch import runtime
    layers, net, imgs = tiny
    params, _ = inputs.weights(layers, SEED, INIT, DEV)
    state = darknet.batch_statistics(layers, params, nchw(imgs[2:4]))
    b = runtime.ModelBundle(net=net, params=params, state=state, device=DEV,
                            dtype=torch.float32)
    x = imgs[:2]
    got = b.fuse().model().heads(runtime.preprocess(x.numpy(), device=DEV))
    want = darknet.forward(layers, params, state, nchw(x))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.permute(0, 3, 1, 2), w, rtol=1e-4,
                                   atol=1e-4)
    dets = runtime.ModelBundle(net=net, params=params, state=state,
                               device=DEV, dtype=torch.float32).fuse() \
        .make_infer(conf_thres=0.001, top_k=512, max_det=300)(
            runtime.preprocess(x.numpy(), device=DEV))
    ref = reference_dets(want, layers)
    served = [d[d[:, 4] > 0].numpy() for d in dets]
    got = compare.detections(served, ref, 100, 80)
    assert got['off_share.20'] == 0.0 and got['score_sum_gap'] < 1e-4
    assert all(len(d) > 50 for d in served)
    for d, r in zip(served, ref):
        assert len(d) == len(r)
        np.testing.assert_allclose(d, r.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('quantized,scheme,steps', [(1, 'google', 100),
                                                    (3, 'ptq_cos', 0)])
def test_quant_sim_and_engine(tiny, quantized, scheme, steps):
    """The calibrated sims' scales equal; their head maps and the int8
    engine's detections held as the cells hold them."""
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.compress.quant import make_quant_apply
    layers, net, imgs = tiny
    params, state = inputs.weights(layers, SEED, INIT, DEV)
    zero = {k: {f: torch.zeros_like(t) for f, t in d.items()}
            for k, d in state.items()}
    b = runtime.load_model(CFG, device=DEV, quantized=quantized, steps=steps)
    b.params = {k: {**b.params[k], **{f: t.clone() for f, t in v.items()}}
                for k, v in params.items()}
    b.state = {k: {f: t.clone() for f, t in v.items()} for k, v in zero.items()}
    sim = darknet.QuantSim(layers, params, zero, scheme, 8, steps, DEV)
    for c in range(2):
        b.apply(runtime.preprocess(imgs[2 * c:2 * c + 2].numpy(), device=DEV),
                train=True)
        sim.calibrate(nchw(imgs[2 * c:2 * c + 2]))
    for k, (wq, bq, aq) in sim.conv_q.items():
        assert [float(q.s) for q in (wq, bq, aq)] == [
            float(b.qstate[k][n]['scale']) for n in ('wq', 'bq', 'aq')], k
    x = imgs[4:6]
    xp = runtime.preprocess(x.numpy(), device=DEV)
    want = sim.heads(nchw(x))
    got = make_quant_apply(net, b.qcfg, heads_only=True)(
        b.params, b.state, b.qstate, xp)[0]
    for g, w in zip(got, want):
        # one rounding apart in a conv sum moves a code by a quantum, and
        # random weights spread it: most codes still agree
        same = (g.permute(0, 3, 1, 2) == w).float().mean()
        assert same > 0.3, float(same)
    dets = b.make_infer(conf_thres=0.001, top_k=512, max_det=300)(xp)
    ref = reference_dets(want, layers, 'cells')
    cell = {'google': 'yolov3-608', 'ptq_cos': 'yolov4-608'}[scheme]
    chk = json.load(open(os.path.join(REPO, 'benchmark', 'workloads',
                                      f'{cell}.int8-serve.json')))['check']
    got = compare.detections([d[d[:, 4] > 0].numpy() for d in dets], ref,
                             chk['top'], 80)
    for n, lim in chk['limits'].items():
        assert got[n] <= lim, (n, got[n])


def test_train_step_f32(tiny):
    """One f32 grad_fn and update_fn of the port against the reference's
    loss, gradients and SGD step."""
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.optim import PerGroupScalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    layers, net, imgs = tiny
    params, state = inputs.weights(layers, SEED, INIT, DEV)
    wl = json.load(open(os.path.join(REPO, 'benchmark', 'workloads',
                                     'yolov3-608.train.json')))
    t = torch.from_numpy(inputs.targets(SEED, 0, 2, 80))
    anchors = [np.asarray(l.anchors) / l.yolo_stride
               for l in net.layers if l.kind == 'yolo']
    grad_fn, update_fn = make_train_functions(net, anchors, 80,
                                              LossHyp(**wl['hyp']))
    ts = init_train_state(net, params, state, compute_dtype=None, device=DEV)
    x = nchw(imgs[:2])
    ts, items = grad_fn(ts, x.permute(0, 2, 3, 1), t,
                        torch.ones(len(t), dtype=torch.bool), 1.0, 0.125)
    grads = {f'{k}.{f}': p.grad.clone() for k, d in ts.params.items()
             for f, p in d.items()}
    o = wl['optimizer']
    ts = update_fn(ts, PerGroupScalars(lr=(o['lr'],) * 4,
                                       weight_decay=(o['weight_decay'], 0, 0, 0),
                                       momentum=o['momentum']))
    ref = {f'{k}.{f}': t_.clone().requires_grad_(True)
           for k, d in params.items() for f, t_ in d.items()}
    tree = {}
    for key, v in ref.items():
        k, f = key.split('.')
        tree.setdefault(k, {})[f] = v
    heads = darknet.forward_train(layers, tree, x)
    parts = ref_loss.yolo_loss(heads, layers, t, wl['hyp'], SIZE)
    (parts[3] * 0.125).backward()
    torch.testing.assert_close(items, torch.stack(parts).detach(), rtol=1e-5,
                               atol=1e-6)
    for key, g in grads.items():
        assert float((g - ref[key].grad).norm()) <= 1e-4 * float(
            ref[key].grad.norm()), key
    ref_loss.sgd_step(ref, {k: v.grad for k, v in ref.items()}, {},
                      lambda f: o['lr'],
                      lambda f: o['weight_decay'] if f == 'w' else 0.0,
                      o['momentum'])
    for k, d in ts.params.items():
        for f, p in d.items():
            torch.testing.assert_close(p.detach(), ref[f'{k}.{f}'].detach(),
                                       rtol=1e-5, atol=1e-7)
