"""The int8 engine's serving step replayed as CUDA graphs
(``yolo_tpu_torch/runtime.py`` ``StepGraphs``): when a call captures,
replays or runs eagerly, the counters each call advances, and on the card
the replayed detections against the eager step's.

The CPU tests hold the gate (CPU tensors and a ``mesh`` never capture; the
policy of shapes, the bound on graphs and the profiler through a stand-in
graph) and the counters' arithmetic. Tests marked ``gpu`` capture and
replay google yolov3 and cos-PTQ yolov4 at 64 px and yolov3-mobilenet at
96 px on the card and skip without one; they need no jax:
``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_serve_graphs.py``.
"""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import ROOT, TOY_CFG, images
from yolo_tpu_torch import runtime as trt
from yolo_tpu_torch.ops.conv_int8 import float_edge_conv, grouped_conv_int8
from yolo_tpu_torch.utils import profiler as P

LEAKY_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky')
MOBILE_CFG = os.path.join(ROOT, 'cfg', 'yolov3-mobilenet',
                          'yolov3-mobilenet-visdrone.cfg')
KW = dict(conf_thres=0.001, iou_thres=0.6, top_k=64, max_det=32)
SERVE = ('serve.eager_calls', 'serve.graph_captures', 'serve.graph_replays')


def _serve_counts():
    return tuple(P.counter(k) for k in SERVE)


def _bundle(cfg, dev, size, quantized=1):
    b = trt.load_model(cfg, device=dev, quantized=quantized, steps=100,
                       generator=torch.Generator().manual_seed(0))
    b.apply(trt.preprocess(images(3, 2, size), device=dev), train=True)
    return b


@pytest.fixture
def toy(tmp_path):
    p = tmp_path / 'leaky.cfg'
    p.write_text(LEAKY_CFG)
    return _bundle(str(p), 'cpu', 64)


# ---------------------------------------------------------- on the CPU

def test_cpu_calls_run_eagerly(toy):
    """A CPU tensor never captures: every call runs the eager step, counts
    one eager call, and returns a tensor of its own."""
    infer = toy.make_infer(**KW)
    assert isinstance(infer, trt.StepGraphs)
    x = trt.preprocess(images(4, 2, 64), device='cpu')
    n0 = _serve_counts()
    outs = [infer(x) for _ in range(3)]
    assert _serve_counts() == (n0[0] + 3, n0[1], n0[2])
    assert not infer.graphs
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert len({o.data_ptr() for o in outs}) == 3


def test_mesh_never_captures(toy):
    """A ``mesh`` serves through a plain eager callable, which counts each
    call and gives the whole-image step's detections."""
    from yolo_tpu_torch.parallel import make_mesh
    infer = toy.make_infer(mesh=make_mesh(device='cpu'), **KW)
    assert not isinstance(infer, trt.StepGraphs)
    x = trt.preprocess(images(4, 2, 64), device='cpu')
    n0 = _serve_counts()
    got = [infer(x) for _ in range(2)]
    assert _serve_counts() == (n0[0] + 2, n0[1], n0[2])
    want = toy.make_infer(**KW)(x)
    assert all(torch.equal(g, want) for g in got)


class _Card:
    """A stand-in for a CUDA batch: what the gate reads of one."""
    is_cuda = True
    dtype = torch.float32
    device = torch.device('cuda', 0)

    def __init__(self, bs, size=64):
        self.shape = torch.Size((bs, size, size, 3))


class _StandInGraph:
    """Records captures and replays in place of a CUDA graph, in ``log``
    with the eager steps."""
    log = []

    def __init__(self, step, x):
        self.out = torch.zeros(1)
        self.log.append(('capture', x.shape[0]))

    def replay(self, x):
        self.log.append(('replay', x.shape[0]))
        return self.out.clone()


@pytest.fixture
def stand_in(monkeypatch):
    _StandInGraph.log = []
    monkeypatch.setattr(trt, '_Graph', _StandInGraph)
    return trt.StepGraphs(
        lambda x: _StandInGraph.log.append(('eager', x.shape[0])))


def _ran():
    return [e[0] for e in _StandInGraph.log]


@pytest.mark.parametrize('batches,want', [
    # a repeated shape: eager, capture, then replays
    ((2, 2, 2, 2), ['eager', 'capture', 'replay', 'replay']),
    # shapes that change on every call stay eager
    ((1, 2, 1, 2, 3), ['eager'] * 5),
    # a new shape runs eagerly, then captures; a kept one replays at once
    ((2, 2, 1, 1, 2, 1), ['eager', 'capture', 'eager', 'capture', 'replay',
                          'replay']),
], ids=['repeated', 'alternating', 'new_shape'])
def test_gate_by_shape(stand_in, batches, want):
    n0 = _serve_counts()
    for bs in batches:
        stand_in(_Card(bs))
    assert _ran() == want
    assert [e[1] for e in _StandInGraph.log] == list(batches)
    assert _serve_counts() == (n0[0] + want.count('eager'),
                               n0[1] + want.count('capture'),
                               n0[2] + want.count('replay'))


def test_graphs_kept_are_bounded(stand_in):
    """Each of GRAPHS_KEPT + 1 shapes captured in turn: the least recently
    used is dropped, and runs eagerly when it comes back."""
    last = trt.GRAPHS_KEPT + 1
    for bs in range(1, last + 1):
        stand_in(_Card(bs))
        stand_in(_Card(bs))
    assert [k[0][0] for k in stand_in.graphs] == list(range(2, last + 1))
    stand_in(_Card(1))
    stand_in(_Card(last))
    assert _StandInGraph.log[-2:] == [('eager', 1), ('replay', last)]


def test_profiler_session_runs_eagerly(stand_in):
    """Under a profiler session a kept shape runs the eager step, so that
    the spans measure their layers; after it, it replays again."""
    stand_in(_Card(2))
    stand_in(_Card(2))
    with profile(activities=[ProfilerActivity.CPU]):
        assert P.tracing()
        stand_in(_Card(2))
        stand_in(_Card(2))
    assert not P.tracing()
    stand_in(_Card(2))
    assert _ran() == ['eager', 'capture', 'eager', 'eager', 'replay']


def test_replay_adds_one_steps_counts(toy):
    """What one eager step adds to the always-on counters and the
    ``.calls`` attributes, taken by ``_added`` and added again by
    ``_add``, is the same again: a replay counts as the eager step does."""
    infer = toy.make_infer(**KW)
    x = trt.preprocess(images(4, 2, 64), device='cpu')
    before = trt._tally()
    with torch.inference_mode():
        infer.step(x)
    adds = trt._added(before, trt._tally())
    names = dict(adds)
    assert names['float_edge.calls'] == 1           # the stem
    assert names['float_edge_conv.calls'] == 1
    assert names['nms.slots'] == 2 * KW['top_k']
    assert 'serve.eager_calls' not in names
    mid = trt._tally()
    trt._add(adds)
    assert trt._added(mid, trt._tally()) == adds
    assert float_edge_conv.calls == mid['float_edge_conv.calls'] + 1
    assert grouped_conv_int8.calls == mid['grouped_conv_int8.calls']


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


CARD_MODELS = [(os.path.join(ROOT, 'cfg', 'yolov3', 'yolov3.cfg'), 1, 64),
               (os.path.join(ROOT, 'cfg', 'yolov4', 'yolov4.cfg'), 3, 64),
               (MOBILE_CFG, 1, 96)]
CARD_IDS = ['yolov3_google_64', 'yolov4_cos_ptq_64', 'mobilenet_google_96']


def _eager(infer, x):
    """The eager step's detections of x and what it adds to the counters."""
    before = trt._tally()
    with torch.inference_mode():
        out = infer.step(x)
    torch.cuda.synchronize()
    return out, trt._added(before, trt._tally())


@pytest.mark.gpu
@pytest.mark.parametrize('cfg,quantized,size', CARD_MODELS, ids=CARD_IDS)
def test_replay_equals_the_eager_step(cuda, cfg, quantized, size):
    """Five calls of one shape on four batches: the first runs eagerly,
    the second captures, the rest replay. Each call's detections are
    bit-equal to the eager step's of its batch, an earlier call's tensor
    is unchanged by the later ones, and each call advances every counter
    and ``.calls`` attribute by what the eager step does."""
    b = _bundle(cfg, cuda, size, quantized)
    infer = b.make_infer(**KW)
    xs = [trt.preprocess(images(10 + i, 2, size), device=cuda)
          for i in range(4)]
    order = [0, 1, 2, 3, 1]
    want, step_adds = zip(*(_eager(infer, x) for x in xs))
    assert all(a == step_adds[0] for a in step_adds)
    assert dict(step_adds[0])['k2.launches'] > 0
    assert dict(step_adds[0])['k1.launches'] == 1
    n0 = _serve_counts()
    got, kept = [], []
    for i in order:
        before = trt._tally()
        out = infer(xs[i])
        torch.cuda.synchronize()
        adds = dict(trt._added(before, trt._tally()))
        ran = [k for k in SERVE if adds.pop(k, 0) == 1]
        assert len(ran) == 1 and adds == dict(step_adds[0]), (i, ran)
        assert torch.equal(out, want[i]), i
        got.append(out)
        kept.append(out.clone())
    assert _serve_counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 3)
    assert all(torch.equal(g, k) for g, k in zip(got, kept))
    assert len(infer.graphs) == 1


@pytest.mark.gpu
def test_profiler_and_new_shapes_on_the_card(cuda):
    """A profiler session runs the eager step with its spans recorded; a
    new shape runs eagerly, then captures; the first shape still
    replays, bit-equal to the eager step."""
    b = _bundle(os.path.join(ROOT, 'cfg', 'yolov3', 'yolov3.cfg'), cuda, 64)
    infer = b.make_infer(**KW)
    x2 = trt.preprocess(images(20, 2, 64), device=cuda)
    x1 = trt.preprocess(images(21, 1, 64), device=cuda)
    infer(x2)
    infer(x2)
    P.reset()
    n0 = _serve_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = infer(x2)
    names = {r.name for r in P.records()}
    assert {'serve.infer', 'engine.conv', 'engine.shortcut', 'nms.decode',
            'nms.suppress'} <= names
    assert _serve_counts() == (n0[0] + 1, n0[1], n0[2])
    want2 = _eager(infer, x2)[0]
    assert torch.equal(traced, want2)
    for _ in range(2):
        out1 = infer(x1)
    assert _serve_counts() == (n0[0] + 2, n0[1] + 1, n0[2])
    assert torch.equal(out1, _eager(infer, x1)[0])
    assert torch.equal(infer(x2), want2)
    assert _serve_counts() == (n0[0] + 2, n0[1] + 1, n0[2] + 1)
    assert len(infer.graphs) == 2
