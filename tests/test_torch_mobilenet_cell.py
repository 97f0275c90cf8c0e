"""The benchmark's ``yolov3-mobilenet-640`` configuration and its cell,
``yolov3-mobilenet-640.int8-serve``, at tiny sizes on the CPU: the
configuration's cfg and counts, the port's float heads and int8 engine
against the plain reference (``benchmark/reference``), the spans and
counters the engine opens on the mobile backbone's layers, and the
metrics the cell reports (their readers: ``test_torch_spans.py``). No jax
here."""

import importlib.util
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import ROOT
from benchmark import compare, counts, inputs
from benchmark.common import nchw
from benchmark.reference import darknet, detect
from yolo_tpu_torch.utils import profiler as P

BENCH = os.path.join(ROOT, 'benchmark')
CELL = 'yolov3-mobilenet-640.int8-serve'
CONFIG = json.load(open(os.path.join(BENCH, 'configs',
                                     'yolov3-mobilenet-640.json')))
WORKLOAD = json.load(open(os.path.join(BENCH, 'workloads', f'{CELL}.json')))
MOBILE_CFG = os.path.join('cfg', 'yolov3-mobilenet',
                          'yolov3-mobilenet-visdrone.cfg')
TINY_CFG = os.path.join('cfg', 'yolov3tiny', 'yolov3-tiny.cfg')
INIT = CONFIG['forms']['int8']['init']
DEV = torch.device('cpu')
NEW_READERS = ('engine_grouped_ms', 'engine_float_conv_ms', 'engine_se_ms',
               'grouped_roofline', 'k4_share')


_spec = importlib.util.spec_from_file_location(
    'bench_conftest', os.path.join(BENCH, 'tests', 'conftest.py'))
_bench_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_bench_conftest)
cfg_lines = _bench_conftest.cfg_lines


@pytest.fixture(autouse=True)
def _empty_store():
    P.reset()
    yield
    P.reset()


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """The engine's many small ops at these sizes run fastest on one
    thread, and do not slow to a crawl beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- configuration

def test_config_is_the_cfg_at_640():
    """The configuration's lines are the source cfg's but for the [net]
    section's size; its counts at 640 px and a batch of 8."""
    src = cfg_lines(os.path.join(ROOT, MOBILE_CFG))
    got = CONFIG['darknet_cfg']
    assert len(got) == len(src)
    diff = [(a, b) for a, b in zip(src, got) if a != b]
    assert diff == [('width=416', 'width=640'), ('height=416', 'height=640')]
    assert got.index('width=640') < got.index('[convolutional]')
    assert CONFIG['img_size'] == 640 and CONFIG['classes'] == 10
    layers = darknet.build(got)
    convs = darknet.macs(layers, 640)
    assert len(convs) == CONFIG['convs'] == 70
    paths = list(counts.engine_paths(layers).values())
    assert [paths.count(p) for p in ('k2', 'grouped', 'float')] == [46, 15, 9]
    assert counts.grouped_bound_ms(convs, layers, 8) == pytest.approx(
        0.0737, abs=5e-5)
    assert counts.k2_bound_ms(convs, layers, 8) == pytest.approx(
        0.2635, abs=5e-5)
    assert [l.nc for l in layers if l.kind == 'yolo'] == [10] * 3
    params, _ = inputs.weights(layers, 7, INIT, DEV)
    assert sum(t.numel() for d in params.values()
               for t in d.values()) == CONFIG['parameters']


def test_float_heads_equal_the_references():
    """At 64 px, bs 2, on the seed's weights: the port's float Darknet
    heads against the reference's forward."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import Darknet
    layers = darknet.build(CONFIG['darknet_cfg'])
    params, state = inputs.weights(layers, 2 ** 31 + 99, INIT, DEV)
    net = build_ir(os.path.join(ROOT, MOBILE_CFG))
    x = inputs.images(2 ** 31 + 99, 2, 64, DEV)
    want = darknet.forward(layers, params, state, nchw(x))
    got = Darknet(net, params, state).heads(x.float() / 256.0)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        torch.testing.assert_close(g.permute(0, 3, 1, 2), w, rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------ int8 engine against its sim

def _calibrated(cfg, size, seed):
    """The port's google bundle and the reference's 8-bit sim, each
    calibrated on the same two batches of 2; two more images to serve."""
    from yolo_tpu_torch import runtime
    layers = darknet.build(cfg_lines(os.path.join(ROOT, cfg)))
    params, state = inputs.weights(layers, seed, INIT, DEV)
    zero = {k: {f: torch.zeros_like(t) for f, t in d.items()}
            for k, d in state.items()}
    b = runtime.load_model(os.path.join(ROOT, cfg), device=DEV, quantized=1,
                           steps=100)
    b.params = {k: {**b.params[k], **{f: t.clone() for f, t in v.items()}}
                for k, v in params.items()}
    b.state = {k: {f: t.clone() for f, t in v.items()}
               for k, v in zero.items()}
    imgs = inputs.images(seed, 6, size, DEV)
    for c in range(2):
        b.apply(runtime.preprocess(imgs[2 * c:2 * c + 2].numpy(),
                                   device=DEV), train=True)
    return layers, params, zero, b, imgs


def _sims(layers, params, zero, imgs, bits):
    sim = darknet.QuantSim(layers, params, zero, 'google', bits, 100, DEV)
    for c in range(2):
        sim.calibrate(nchw(imgs[2 * c:2 * c + 2]))
    return sim


def _dets(layers, heads, size):
    wl = WORKLOAD
    boxes, obj, scores, sizes = detect.decode(heads, layers, size)
    return [detect.nms(boxes[j], scores[j],
                       detect.candidates(obj[j], sizes, wl['conf_thres'],
                                         wl['top_k'], 'cells'),
                       wl['conf_thres'], wl['iou_thres'], wl['top_k'],
                       wl['max_det'])
            for j in range(len(heads[0]))]


@pytest.mark.parametrize('served', ['engine', 'int4'])
def test_engine_holds_the_sim_and_int4_does_not(served):
    """At 96 px: the int8 engine's detections against the google sim's,
    under the cell's limits, as its check compares them; the int4 control
    (the sim at 4 bits, calibrated alike, in the engine's place) fails
    them."""
    from yolo_tpu_torch import runtime
    size, seed = 96, 2 ** 31 + 5
    layers, params, zero, b, imgs = _calibrated(MOBILE_CFG, size, seed)
    x = imgs[4:]
    want = _dets(layers, _sims(layers, params, zero, imgs, 8).heads(nchw(x)),
                 size)
    if served == 'engine':
        wl = WORKLOAD
        out = b.make_infer(conf_thres=wl['conf_thres'], iou_thres=wl[
            'iou_thres'], top_k=wl['top_k'], max_det=wl['max_det'])(
            runtime.preprocess(x.numpy(), device=DEV))
        got = [d[d[:, 4] > 0].numpy() for d in out]
    else:
        got = [d.numpy() for d in _dets(
            layers, _sims(layers, params, zero, imgs, 4).heads(nchw(x)),
            size)]
    chk = WORKLOAD['check']
    gaps = compare.detections(got, want, chk['top'], layers[-1].nc)
    assert all(len(w) > 100 for w in want)
    assert set(chk['limits']) == {'score_sum_gap', 'mass_gap'}
    held = [gaps[n] <= lim for n, lim in chk['limits'].items()]
    assert all(held) if served == 'engine' else not all(held), gaps


# ------------------------------------------------------ spans and counters

@pytest.mark.parametrize('cfg,want', [
    (MOBILE_CFG, {'engine.conv': 70, 'engine.grouped': 15,
                  'engine.float_conv': 9, 'engine.se': 8}),
    (TINY_CFG, {'engine.conv': 13, 'engine.grouped': 0,
                'engine.float_conv': 1, 'engine.se': 0})])
def test_engine_spans_and_counters_of_one_call(cfg, want):
    """One served batch: the grouped and float-edge convs each in a span
    of their own inside ``engine.conv``, SE in ``engine.se``, and the
    always-on counters one a call."""
    from yolo_tpu_torch import runtime
    layers, _, _, b, imgs = _calibrated(cfg, 64, 7)
    infer = b.make_infer(conf_thres=0.001, top_k=64, max_det=32)
    xp = runtime.preprocess(imgs[4:].numpy(), device=DEV)
    infer(xp)                                   # off: counted, no spans
    g0, f0 = P.counter('grouped.calls'), P.counter('float_edge.calls')
    assert (g0, f0) == (want['engine.grouped'], want['engine.float_conv'])
    assert P.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        infer(xp)
    recs = P.records()
    assert {n: sum(r.name == n for r in recs) for n in want} == want
    assert want['engine.conv'] == len(darknet.convs(layers))
    for r in recs:
        if r.name in ('engine.grouped', 'engine.float_conv'):
            assert recs[r.parent].name == 'engine.conv'
        if r.name == 'engine.se':
            assert recs[r.parent].name == 'serve.infer'
    assert P.counter('grouped.calls') - g0 == want['engine.grouped']
    assert P.counter('float_edge.calls') - f0 == want['engine.float_conv']
    c = P.summary()['counters']
    assert c.get('grouped.calls', 0) == want['engine.grouped']
    assert c['float_edge.calls'] == want['engine.float_conv']


# ---------------------------------------------------------- the cell

def test_cell_lists_its_metrics():
    """The cell reports the serving cells' metrics and the five of its own
    layers, which no other cell lists."""
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    cell = next(c for c in bench['workloads'] if c['name'] == CELL)
    assert cell['chips'] == 1 and cell['config'] == CONFIG['name']
    e2e = [m['name'] for m in bench['end_to_end']
           if CELL in m.get('workloads', [CELL])]
    assert e2e == ['images_per_s', 'batch_ms_p95', 'setup_s']
    mine = {m['name'] for m in bench['per_layer']
            if CELL in m.get('workloads', ())}
    v3 = {m['name'] for m in bench['per_layer']
          if 'yolov3-608.int8-serve' in m.get('workloads', ())}
    assert mine == v3 | set(NEW_READERS) and len(v3) == 14
    for m in bench['per_layer']:
        if m['name'] in NEW_READERS:
            assert m['workloads'] == [CELL] and m['moves'] == 'images_per_s'
