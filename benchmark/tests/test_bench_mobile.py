"""The reference on the mobile backbones' cfgs (yolov3-mobilenet,
yolov3tiny-mobilenet-small, yolov3-ghostnet, yolov3tiny-efficientnetB0:
depthwise and grouped convs, SE, avgpool and scale_channels, the hard
activations), at a tiny size on the CPU: its float heads against the
port's, the google sim's detections against the int8 engine's, and the
counts of K2's and the grouped convs against the convs the engine ran.
The draws and counts of the existing configurations are held to the
figures they had before these layer kinds were written."""

import glob
import hashlib
import json
import os

import pytest
import torch

from conftest import BENCH, REPO, cfg_lines

from benchmark import compare, counts, inputs
from benchmark.common import nchw
from benchmark.reference import darknet, detect

FAMILIES = ('yolov3-mobilenet', 'yolov3tiny-mobilenet-small',
            'yolov3-ghostnet', 'yolov3tiny-efficientnetB0')
MOBILE = sorted(os.path.relpath(p, REPO) for f in FAMILIES
                for p in glob.glob(os.path.join(REPO, 'cfg', f, '*.cfg')))
# the cfgs the reference took before the mobile layer kinds
EARLIER = ['cfg/yolov3/yolov3.cfg', 'cfg/yolov3/yolov3-spp.cfg',
           'cfg/yolov4/yolov4.cfg', 'cfg/yolov4/yolov4-relu.cfg',
           'cfg/yolov3tiny/yolov3-tiny.cfg', 'cfg/yolov4tiny/yolov4-tiny.cfg',
           'cfg/yolov2/yolov2.cfg']
ONE_EACH = {'mobilenet': 'cfg/yolov3-mobilenet/yolov3-mobilenet-visdrone.cfg',
            'mobilenet-small': 'cfg/yolov3tiny-mobilenet-small/'
                               'yolov3tiny-mobilenet-small-visdrone.cfg',
            'ghost': 'cfg/yolov3-ghostnet/yolov3-ghost-coco.cfg',
            'efficientnet': 'cfg/yolov3tiny-efficientnetB0/'
                            'yolov3tiny-efficientnetB0.cfg'}
INIT = {'conv_scale': 1.5, 'bn_gamma': [0.18, 0.42], 'bn_beta_std': 0.5}
DEV = torch.device('cpu')


def load(cfg, seed=7):
    layers = darknet.build(cfg_lines(os.path.join(REPO, cfg)))
    return layers, *inputs.weights(layers, seed, INIT, DEV)


@pytest.mark.parametrize('cfg', MOBILE + EARLIER)
def test_reference_float_heads_equal_the_ports(cfg):
    """At 64 px, bs 2: the reference's heads against the port's Darknet
    forward, and the counts of convs and heads against its IR."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import Darknet
    layers, params, state = load(cfg)
    net = build_ir(os.path.join(REPO, cfg))
    assert len(darknet.convs(layers)) == sum(
        l.kind in ('conv', 'depthwise') for l in net.layers)
    x = inputs.images(7, 2, 64, DEV)
    want = darknet.forward(layers, params, state, nchw(x))
    got = Darknet(net, params, state).heads(x.float() / 256.0)
    assert len(got) == len(want) == len(net.yolo_layers)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.permute(0, 3, 1, 2), w, rtol=1e-4,
                                   atol=1e-4)
    assert len(darknet.macs(layers, 64)) == len(darknet.convs(layers))


def _calibrated(cfg, size, seed):
    """The port's google bundle and the reference's sim, each calibrated
    on the same two batches of 2, and two more images to serve."""
    from yolo_tpu_torch import runtime
    layers, params, state = load(cfg, seed)
    zero = {k: {f: torch.zeros_like(t) for f, t in d.items()}
            for k, d in state.items()}
    b = runtime.load_model(os.path.join(REPO, cfg), device=DEV, quantized=1,
                           steps=100)
    b.params = {k: {**b.params[k], **{f: t.clone() for f, t in v.items()}}
                for k, v in params.items()}
    b.state = {k: {f: t.clone() for f, t in v.items()} for k, v in zero.items()}
    sim = darknet.QuantSim(layers, params, zero, 'google', 8, 100, DEV)
    imgs = inputs.images(seed, 6, size, DEV)
    for c in range(2):
        batch = imgs[2 * c:2 * c + 2]
        b.apply(runtime.preprocess(batch.numpy(), device=DEV), train=True)
        sim.calibrate(nchw(batch))
    return layers, b, sim, imgs[4:]


@pytest.mark.parametrize('family', ['mobilenet', 'ghost'])
def test_sim_detections_hold_the_engines(family):
    """At 96 px: the calibrated scales equal, and the engine's detections
    held to the sim's as the yolov3 int8 cell holds them."""
    from yolo_tpu_torch import runtime
    size = 96
    layers, b, sim, x = _calibrated(ONE_EACH[family], size, 7)
    for k, (wq, bq, aq) in sim.conv_q.items():
        assert [float(q.s) for q in (wq, bq, aq)] == [
            float(b.qstate[k][n]['scale']) for n in ('wq', 'bq', 'aq')], k
    dets = b.make_infer(conf_thres=0.001, top_k=512, max_det=300)(
        runtime.preprocess(x.numpy(), device=DEV))
    boxes, obj, scores, sizes = detect.decode(sim.heads(nchw(x)), layers,
                                              size)
    ref = [detect.nms(boxes[j], scores[j],
                      detect.candidates(obj[j], sizes, 0.001, 512, 'cells'),
                      0.001, 0.6, 512, 300) for j in range(len(x))]
    chk = json.load(open(os.path.join(BENCH, 'workloads',
                                      'yolov3-608.int8-serve.json')))['check']
    got = compare.detections([d[d[:, 4] > 0].numpy() for d in dets], ref,
                             chk['top'], layers[-1].nc)
    assert all(len(r) > 100 for r in ref)
    for n, lim in chk['limits'].items():
        assert got[n] <= lim, (n, got[n])


@pytest.mark.parametrize('family', list(ONE_EACH))
def test_counts_name_the_convs_the_engine_runs(family):
    """K2's calls and the grouped ones by the counts, against the engine's
    counters of one batch: ``grouped_conv_int8`` and ``float_edge_conv``
    by their calls, the remaining convs K2's."""
    from yolo_tpu_torch import runtime
    from yolo_tpu_torch.ops import conv_int8
    size = 64
    layers, b, _, x = _calibrated(ONE_EACH[family], size, 7)
    infer = b.make_infer(conf_thres=0.001, top_k=512, max_det=300)
    xp = runtime.preprocess(x.numpy(), device=DEV)
    g0 = conv_int8.grouped_conv_int8.calls
    f0 = conv_int8.float_edge_conv.calls
    infer(xp)
    grouped = conv_int8.grouped_conv_int8.calls - g0
    floated = conv_int8.float_edge_conv.calls - f0
    convs = darknet.macs(layers, size)
    assert len(counts.grouped_calls(convs, layers)) == grouped > 0
    paths = counts.engine_paths(layers)
    assert sum(p == 'float' for p in paths.values()) == floated > 1
    assert len(counts.k2_calls(convs, layers)) == (len(convs) - grouped
                                                   - floated)
    assert counts.grouped_bound_ms(convs, layers, 8) > 0


def test_no_grouped_bound_without_grouped_convs():
    layers = darknet.build(cfg_lines(os.path.join(REPO, EARLIER[0])))
    convs = darknet.macs(layers, 608)
    assert counts.grouped_bound_ms(convs, layers, 8) is None
    assert len(counts.k2_calls(convs, layers)) == len(convs) - 1


def _digest(params, state):
    h = hashlib.sha256()
    for tree in (params, state):
        for k in sorted(tree, key=int):
            for f in sorted(tree[k]):
                h.update(f'{k}.{f}'.encode())
                h.update(tree[k][f].contiguous().numpy().tobytes())
    return h.hexdigest()


def test_yolov3_tiny_draw_is_frozen():
    """The weights of a seed, as they were drawn before grouped convs and
    SE layers had draws of their own."""
    layers = darknet.build(cfg_lines(os.path.join(REPO, EARLIER[4])))
    assert _digest(*inputs.weights(layers, 2 ** 31 + 12345, INIT, DEV)) == (
        '1c1816fbad0d9d5906edf44951b60994686ef15e86e46cca93b472af182a7265')


# per configuration: its weights' digest (seed 2718281828), conv_ops,
# k2_bound_ms and k1_bound_ms of a batch of 8 at 608 px, as they were
@pytest.mark.parametrize('config,digest,figures', [
    ('yolov3-608',
     '75ef59ab37ec71610d26fb8e60f453c4180d18494c94faf7c98c98dfe061e0ba',
     (1125535203328.0, 0.7096952146665958, 0.00021892202985074625)),
    ('yolov4-608',
     '66ee49612278f6d6806cf665fce5a753f0fd905ace4379e4005e5a9d24b1caa4',
     (1027115859968.0, 0.8194637115157507, 0.00021892202985074625))])
def test_existing_configurations_are_unchanged(config, digest, figures):
    cfg = json.load(open(os.path.join(BENCH, 'configs', f'{config}.json')))
    layers = darknet.build(cfg['darknet_cfg'])
    init = cfg['forms']['int8']['init']
    assert _digest(*inputs.weights(layers, 2718281828, init, DEV)) == digest
    convs = darknet.macs(layers, 608)
    assert (counts.conv_ops(convs, 8), counts.k2_bound_ms(convs, layers, 8),
            counts.k1_bound_ms(8, 512, [512] * 8)) == figures
    pool = inputs.images(2718281828, 2, 608, DEV).numpy().tobytes()
    assert hashlib.sha256(pool).hexdigest() == (
        '0d286ebbb77e95783c00ba76c5ddbbd5746564695977f4c53f0b54bf47d765dd')
