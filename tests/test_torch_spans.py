"""The program's spans and counters (``yolo_tpu_torch/utils/profiler.py``),
where the serving and training paths open them, the benchmark's readers of
them (``benchmark/metrics/``), and a traced run of the benchmark's tiny
cells on the CPU that reports every metric they feed. No jax here."""

import importlib.util
import math
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import ROOT, TOY_CFG, images
from yolo_tpu_torch.utils import profiler as P

CPU = [ProfilerActivity.CPU]
LEAKY_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky')
SERVE_READERS = ('engine_conv_ms', 'engine_shortcut_ms', 'engine_concat_ms',
                 'decode_ms', 'suppress_ms', 'k1_valid_share',
                 'launch_us.serve')
TRAIN_READERS = ('forward_ms', 'loss_ms', 'backward_ms', 'launch_us.train')
# the serving readers of the mobile backbone's spans (its cell alone)
MOBILE_READERS = ('engine_grouped_ms', 'engine_float_conv_ms', 'engine_se_ms',
                  'grouped_roofline', 'k4_share')
GROUPED_BOUND_MS = 0.0737


@pytest.fixture(autouse=True)
def _empty_store():
    P.reset()
    yield
    P.reset()


def reader(name):
    path = os.path.join(ROOT, 'benchmark', 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'metric_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------- the store

def test_off_records_nothing():
    a = P.span('serve.infer')
    assert a is P.span('engine.conv')           # one shared no-op context
    with a:
        P.count('nms.valid', torch.ones(4, dtype=torch.bool))
        P.count('k2.launches', 3)
    assert P.records() == []
    assert P.summary() == {'spans': {}, 'counters': {}}
    assert P.counter('k2.launches') == 3        # integers count always


def test_spans_nest_under_the_profiler():
    with profile(activities=CPU) as prof:
        with torch.profiler.record_function('outer'):
            for _ in range(2):
                with P.span('serve.infer'):
                    with P.span('engine.conv'):
                        torch.ones(8) + 1
                    with P.span('nms.suppress'):
                        P.count('nms.valid', torch.tensor([True, False]))
                        P.count('nms.slots', 2)
    recs = P.records()
    assert [r.name for r in recs] == ['serve.infer', 'engine.conv',
                                      'nms.suppress'] * 2
    assert [r.parent for r in recs] == [-1, 0, 0, -1, 3, 3]
    assert [r.top for r in recs] == [0, 0, 0, 3, 3, 3]
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    assert abs(recs[0].start_ns - time.time_ns()) < 60e9   # the Unix epoch
    events = prof.events()
    outer = next(e for e in events if e.name == 'outer')
    mine = [e for e in events if e.name in ('serve.infer', 'engine.conv',
                                            'nms.suppress')]
    assert len(mine) == 6
    for e in mine:
        assert (outer.time_range.start <= e.time_range.start
                <= e.time_range.end <= outer.time_range.end)
    s = P.summary()
    assert {n: v['count'] for n, v in s['spans'].items()} == {
        'serve.infer': 2, 'engine.conv': 2, 'nms.suppress': 2}
    for v in s['spans'].values():       # on the CPU, device time is host time
        assert v['device_s'] == v['host_s'] > 0
    assert s['counters'] == {'nms.valid': 2, 'nms.slots': 4}


def test_summary_first_keeps_the_first_top_level_spans():
    with profile(activities=CPU):
        for i in range(3):
            with P.span('train.grad'):
                with P.span('train.forward'):
                    P.count('seen', i + 1)
            with P.span('train.update'):
                pass
        with P.span('engine.conv'):             # a top-level name of its own
            pass
    s = P.summary(first=2)
    assert {n: v['count'] for n, v in s['spans'].items()} == {
        'train.grad': 2, 'train.forward': 2, 'train.update': 2,
        'engine.conv': 1}
    assert s['counters'] == {'seen': 3}
    assert P.summary()['spans']['train.grad']['count'] == 3
    assert P.summary()['counters'] == {'seen': 6}


# ---------------------------------------------- where the program opens them

def _int8_bundle(tmp_path):
    from yolo_tpu_torch import runtime
    p = tmp_path / 'leaky.cfg'
    p.write_text(LEAKY_CFG)
    b = runtime.load_model(str(p), device='cpu', quantized=1, steps=100,
                           generator=torch.Generator().manual_seed(0))
    for k in range(2):
        b.apply(runtime.preprocess(images(3 + k, 2, 64), device='cpu'),
                train=True)
    return b


def test_int8_engine_spans(tmp_path):
    from yolo_tpu_torch import runtime
    b = _int8_bundle(tmp_path)
    infer = b.make_infer(conf_thres=0.01, top_k=64, max_det=32)
    x = runtime.preprocess(images(9, 2, 64), device='cpu')
    infer(x)                                    # off: nothing kept
    assert P.records() == []
    with profile(activities=CPU):
        infer(x)
    recs = P.records()
    kinds = [l.kind for l in b.net.layers]
    routes = [l for l in b.net.layers if l.kind == 'route'
              and len(l.layers) > 1]
    assert routes and kinds.count('shortcut') == 3
    want = {'serve.infer': 1, 'engine.conv': kinds.count('conv'),
            'engine.float_conv': 1, 'engine.shortcut': kinds.count('shortcut'),
            'engine.concat': len(routes), 'nms.decode': 1,
            'nms.suppress': 1}
    assert {n: sum(r.name == n for r in recs) for n in want} == want
    assert len(recs) == sum(want.values())
    assert recs[0].name == 'serve.infer' and recs[0].parent == -1
    assert all(r.top == 0 for r in recs[1:])
    # the float stem's conv inside its engine.conv, the rest under the batch
    assert [r.parent for r in recs[1:3]] == [0, 1]
    assert [r.name for r in recs[1:3]] == ['engine.conv', 'engine.float_conv']
    assert all(r.parent == 0 for r in recs[3:])
    c = P.summary()['counters']
    assert c['nms.slots'] == 2 * 64 and 0 < c['nms.valid'] <= 128


def test_train_step_spans(tmp_path):
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import init_params
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.optim import PerGroupScalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    p = tmp_path / 'toy.cfg'
    p.write_text(TOY_CFG)
    net = build_ir(str(p))
    params, state = init_params(net, torch.Generator().manual_seed(0))
    ts = init_train_state(net, params, state, compute_dtype=None,
                          device='cpu')
    anchors = [np.asarray(l.anchors) / l.yolo_stride
               for l in net.layers if l.kind == 'yolo']
    grad_fn, update_fn = make_train_functions(net, anchors, 2, LossHyp())
    x = torch.from_numpy(images(5, 2, 64)).float().div(256.0)
    tgt = torch.tensor([[0, 1, 0.5, 0.5, 0.2, 0.3], [1, 0, 0.3, 0.6, 0.1,
                                                       0.1]])
    valid = torch.ones(2, dtype=torch.bool)
    sc = PerGroupScalars(lr=(0.01,) * 4, weight_decay=(0.0,) * 4,
                         momentum=0.9)
    with profile(activities=CPU):
        for _ in range(2):
            ts, _ = grad_fn(ts, x, tgt, valid, 1.0, 1.0)
            ts = update_fn(ts, sc)
    recs = P.records()
    assert [r.name for r in recs] == ['train.grad', 'train.forward',
                                      'train.loss', 'train.backward',
                                      'train.update'] * 2
    assert [r.parent for r in recs] == [-1, 0, 0, 0, -1,
                                        -1, 5, 5, 5, -1]
    assert [r.top for r in recs] == [0, 0, 0, 0, 4, 5, 5, 5, 5, 9]


# ------------------------------------------------------ the benchmark's readers

def _serving_store(n_batches, grouped_calls=15):
    """Spans of ``n_batches`` served batches on the CPU, as the int8 engine
    opens them, with a little work in each; batch i launches K4 for all but
    i of its grouped calls."""
    with profile(activities=CPU):
        for i in range(n_batches):
            with P.span('serve.infer'):
                for name in ('engine.conv', 'engine.shortcut',
                             'engine.concat', 'nms.decode', 'engine.se'):
                    with P.span(name):
                        time.sleep(0.001)
                for name in ('engine.grouped', 'engine.float_conv'):
                    with P.span('engine.conv'), P.span(name):
                        time.sleep(0.001)
                P.count('grouped.calls', grouped_calls)
                P.count('k4.launches', max(grouped_calls - i, 0))
                with P.span('nms.suppress'):
                    P.count('nms.valid', torch.arange(8) < 6 - i)
                    P.count('nms.slots', 8)


def _per_top(name, top_name, n):
    """ms of ``name`` a span of ``top_name``, over the first n of them,
    from the finished spans' host clock."""
    recs = P.records()
    tops = [i for i, r in enumerate(recs)
            if r.name == top_name and r.parent == -1][:n]
    ns = sum(r.end_ns - r.start_ns for r in recs
             if r.name == name and r.top in tops)
    return ns / 1e6 / len(tops)


@pytest.mark.parametrize('name', SERVE_READERS + MOBILE_READERS)
def test_serving_readers(name):
    rec = {'steps': 2, 'kernels': 40, 'driver': 'serve',
           'grouped_bound_ms': GROUPED_BOUND_MS}
    read = reader(name)
    assert read(rec) is None                    # an empty store
    if name in ('grouped_roofline', 'k4_share'):   # no grouped call counted
        _serving_store(3, grouped_calls=0)
        assert read(rec) is None
        P.reset()
    _serving_store(3)
    span = {'engine_conv_ms': 'engine.conv',
            'engine_shortcut_ms': 'engine.shortcut',
            'engine_concat_ms': 'engine.concat', 'decode_ms': 'nms.decode',
            'suppress_ms': 'nms.suppress',
            'engine_grouped_ms': 'engine.grouped',
            'engine_float_conv_ms': 'engine.float_conv',
            'engine_se_ms': 'engine.se'}.get(name)
    if span:
        want = _per_top(span, 'serve.infer', 2)
    elif name == 'grouped_roofline':
        want = 100.0 * GROUPED_BOUND_MS / _per_top('engine.grouped',
                                                   'serve.infer', 2)
        assert read({**rec, 'grouped_bound_ms': None}) is None
    elif name == 'k4_share':
        want = 100.0 * (15 + 14) / 30
    elif name == 'k1_valid_share':
        want = 100.0 * (6 + 5) / 16
    else:
        want = 1e3 * _per_top('serve.infer', 'serve.infer', 2) / (40 / 2)
    assert read(rec) == pytest.approx(want, rel=1e-9)
    assert read(rec) > 0


def test_graph_share_reader():
    """``graph_share.serve``: the replayed share of the serving calls, from
    the always-on counters whether or not tracing was on; None without a
    serving call counted and in a training cell."""
    read = reader('graph_share.serve')
    rec = {'steps': 2, 'kernels': 40, 'driver': 'serve'}
    assert read(rec) is None
    for name, n in (('serve.eager_calls', 2), ('serve.graph_captures', 1),
                    ('serve.graph_replays', 7)):
        P.count(name, n)
    assert read(rec) == pytest.approx(70.0, rel=1e-12)
    assert read({**rec, 'driver': 'train'}) is None
    with profile(activities=CPU):
        P.count('serve.eager_calls', 10)
    assert read(rec) == pytest.approx(35.0, rel=1e-12)


@pytest.mark.parametrize('name', TRAIN_READERS)
def test_training_readers(name):
    rec = {'steps': 2, 'kernels': 60, 'driver': 'train'}
    read = reader(name)
    assert read(rec) is None
    with profile(activities=CPU):
        for _ in range(3):
            with P.span('train.grad'):
                for s in ('train.forward', 'train.loss', 'train.backward'):
                    with P.span(s):
                        time.sleep(0.001)
            with P.span('train.update'):
                time.sleep(0.001)
    if name == 'launch_us.train':
        want = 1e3 * (_per_top('train.grad', 'train.grad', 2)
                      + _per_top('train.update', 'train.update', 2)) / 30
    else:
        want = _per_top(f'train.{name[:-3]}', 'train.grad', 2)
    assert read(rec) == pytest.approx(want, rel=1e-9)
    assert read(rec) > 0


# ------------------------------------------ a traced run of the tiny cells

@pytest.fixture(scope='module')
def tiny_bench(tmp_path_factory):
    path = os.path.join(ROOT, 'benchmark', 'tests', 'conftest.py')
    spec = importlib.util.spec_from_file_location('bench_tiny', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_tiny(str(tmp_path_factory.mktemp('bench')))


@pytest.mark.parametrize('cell,names', [('tiny.int8-serve', SERVE_READERS),
                                        ('tiny.train', TRAIN_READERS)])
def test_traced_tiny_cell_reports_the_span_metrics(tiny_bench, cell, names):
    from benchmark import run as harness
    r = harness.run(cell, 2 ** 31 + 7, 0.3, 1, device='cpu',
                    root=tiny_bench)[0]
    assert r['correct']
    got = r['metrics']
    # a launch is a device kernel's: the CPU's stretch counts none
    assert got['kernels_per_batch' if 'serve' in cell
               else 'kernels_per_step']['value'] == 0
    names = [n for n in names if not n.startswith('launch_us')]
    for n in names:
        assert n in got and math.isfinite(got[n]['value']), n
    assert not any(n.startswith('launch_us') for n in got)
    if cell == 'tiny.int8-serve':
        # yolov3-tiny has no shortcut
        assert got.pop('engine_shortcut_ms')['value'] == 0.0
        assert got['k1_valid_share']['value'] <= 100.0
        # CPU tensors never take a graph
        assert got['graph_share.serve']['value'] == 0.0
    else:
        # forward, loss and backward lie inside the step's gradient
        parts = sum(got[n]['value'] for n in ('forward_ms', 'loss_ms',
                                               'backward_ms'))
        grad = P.summary(first=2)['spans']['train.grad']
        assert parts <= 1e3 * grad['device_s'] / grad['count']
    assert all(got[n]['value'] > 0 for n in names if n in got)
