"""The port's mAP evaluation (``yolo_tpu_torch.eval``: metrics, the device
matcher, ``evaluate``; the ``python -m yolo_tpu_torch.test`` CLI) against
the JAX package, on the CPU.

- metrics: ``compute_ap``, ``ap_per_class``, ``match_predictions``,
  ``fitness`` equal to JAX's exactly;
- matcher: ``match_device`` equal (bool, exactly) to JAX's ``match_device``
  and to the host loop, on the inputs of
  ``tests/test_metrics.py::test_device_matching_equals_host`` and on
  hand-made claims (two predictions with the same best target, a best
  target already claimed, tied IoUs);
- ``evaluate`` end to end on ``TOY_CFG`` at 64 px, 6 images, bs 4 (a
  ragged tail), f32: the float path, the QAT sim and the int8 engine
  (JAX's ``backend='xla'``, the port's K2 twin), each against JAX's
  ``evaluate`` on the same files. The labels are each model's own top
  detections, so the mAP is far from 0. P, R, mAP, F1, ``maps`` and the
  val losses agree within 1e-4; device and host matching give the same
  result.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EVAL_TOL = dict(rtol=1e-4, atol=1e-4)
LEAKY_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky')
N_IMAGES, BS, SIZE = 6, 4, 64


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old = (torch.get_num_threads(), jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old[0])
    jax.config.update('jax_default_matmul_precision', old[1])


# ------------------------------------------------------------------ metrics

def test_metrics_match_jax():
    from yolo_tpu.eval import metrics as JM
    from yolo_tpu_torch.eval import metrics as TM
    rng = np.random.default_rng(0)
    n, niou = 200, 3
    tp = rng.uniform(0, 1, (n, niou)) < np.array([0.6, 0.45, 0.3])
    conf = rng.uniform(0, 1, n)
    pcls = rng.integers(0, 5, n).astype(np.float64)
    tcls = rng.integers(0, 6, 90).astype(np.float64)     # class 5: no preds
    got, want = TM.ap_per_class(tp, conf, pcls, tcls), JM.ap_per_class(
        tp, conf, pcls, tcls)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][:5].min() > 0 and got[2][5].max() == 0
    rec, pre = np.sort(rng.uniform(0, 1, 30)), rng.uniform(0, 1, 30)
    assert TM.compute_ap(rec, pre) == JM.compute_ap(rec, pre)
    x = rng.uniform(0, 1, (7, 4))
    np.testing.assert_array_equal(TM.fitness(x), JM.fitness(x))
    assert TM.coco80_to_coco91_class() == JM.coco80_to_coco91_class()
    # host matching: several classes, duplicates, misses
    boxes = rng.uniform(0, 200, (12, 2))
    tbox = np.concatenate([boxes, boxes + rng.uniform(10, 60, (12, 2))], 1)
    t_cls = rng.integers(0, 3, 12).astype(np.float64)
    pred = np.concatenate([tbox[rng.integers(0, 12, 30)]
                           + rng.uniform(-8, 8, (30, 4)),
                           np.sort(rng.uniform(0, 1, (30, 1)), 0)[::-1],
                           rng.integers(0, 3, (30, 1))], 1)
    iouv = np.array([0.5, 0.6, 0.75])
    got = TM.match_predictions(pred, t_cls, tbox, iouv)
    np.testing.assert_array_equal(got, JM.match_predictions(pred, t_cls, tbox,
                                                            iouv))
    assert 0 < got[:, 0].sum() < 30


# ------------------------------------------------------------------ matcher

def _matcher_case_random():
    """The inputs of tests/test_metrics.py::test_device_matching_equals_host."""
    rng = np.random.RandomState(7)
    w = h = 320.0
    bs, max_det, max_t, T = 3, 32, 24, 20
    tgt = np.zeros((max_t, 6), np.float32)
    tgt[:T, 0] = rng.randint(0, bs, T)
    tgt[:T, 1] = rng.randint(0, 4, T)
    tgt[:T, 2:4] = rng.uniform(0.2, 0.8, (T, 2))
    tgt[:T, 4:6] = rng.uniform(0.1, 0.3, (T, 2))
    valid = np.zeros(max_t, bool)
    valid[:T] = True
    dets = np.zeros((bs, max_det, 6), np.float32)
    for b in range(bs):
        rows = []
        for t in tgt[:T][tgt[:T, 0] == b]:
            for _ in range(rng.randint(1, 3)):
                c = t[2:6] * [w, h, w, h] + rng.uniform(-6, 6, 4)
                x1, y1 = c[0] - c[2] / 2, c[1] - c[3] / 2
                x2, y2 = c[0] + c[2] / 2, c[1] + c[3] / 2
                cls = t[1] if rng.rand() < 0.8 else rng.randint(0, 4)
                rows.append([x1, y1, x2, y2, rng.uniform(0.2, 1.0), cls])
        for _ in range(6):
            x1, y1 = rng.uniform(0, w - 50, 2)
            rows.append([x1, y1, x1 + rng.uniform(10, 60),
                         y1 + rng.uniform(10, 60),
                         rng.uniform(0.2, 1.0), rng.randint(0, 4)])
        rows = np.asarray(rows, np.float32)
        rows = rows[np.argsort(-rows[:, 4])][:max_det]
        dets[b, :len(rows)] = rows
    return dets, tgt, valid, w, h


def _matcher_case_claims():
    """Image 0: targets A, B (overlapping), C and C' (the same box twice),
    all class 1. Predictions in conf order: p0 on A; p1 nearer A than B
    (its best target is claimed: it gets nothing, not B); p2 on B; p3 on
    C / C' (a tie: the first index, C, is claimed); p4 on C again (its
    best is C, claimed: C' stays unclaimed); p5 on A with class 0 (no
    target of its class); p6 partly out of the image (clipped). Image 1
    has no target; pad rows are conf 0."""
    w = h = 100.0
    px = lambda x1, y1, x2, y2: [(x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                                 (x2 - x1) / w, (y2 - y1) / h]
    A, B, C = (10, 10, 40, 40), (14, 10, 44, 40), (60, 60, 90, 90)
    tgt = np.zeros((8, 6), np.float32)
    for i, box in enumerate((A, B, C, C)):
        tgt[i] = [0, 1, *px(*box)]
    valid = np.zeros(8, bool)
    valid[:4] = True
    rows = [(*A, 0.95, 1), (11, 10, 41, 40, 0.9, 1), (*B, 0.85, 1),
            (*C, 0.8, 1), (61, 60, 91, 90, 0.7, 1), (*A, 0.6, 0),
            (58, 58, 105, 92, 0.5, 1)]
    dets = np.zeros((2, 10, 6), np.float32)
    dets[0, :len(rows)] = rows
    dets[1, 0] = (5, 5, 30, 30, 0.9, 1)
    return dets, tgt, valid, w, h


def _host_correct(dets, tgt, valid, w, h, iouv):
    """The evaluator's host path: per image, the clipped kept rows against
    the image's labels through match_predictions."""
    from yolo_tpu_torch.eval.metrics import match_predictions
    out = []
    t = tgt[valid]
    for b in range(dets.shape[0]):
        pred = dets[b][dets[b][:, 4] > 0].copy()
        pred[:, [0, 2]] = pred[:, [0, 2]].clip(0, w)
        pred[:, [1, 3]] = pred[:, [1, 3]].clip(0, h)
        labels = t[t[:, 0] == b][:, 1:]
        xywh = labels[:, 1:5] * [w, h, w, h]
        tbox = np.concatenate([xywh[:, :2] - xywh[:, 2:] / 2,
                               xywh[:, :2] + xywh[:, 2:] / 2], 1)
        out.append(match_predictions(pred, labels[:, 0], tbox, iouv))
    return out


@pytest.mark.parametrize('case', ['random', 'claims'])
def test_match_device_equals_jax_and_host(case):
    import jax.numpy as jnp
    from yolo_tpu.eval.matching import match_device as jmatch
    from yolo_tpu_torch.eval.matching import match_device
    dets, tgt, valid, w, h = (_matcher_case_random() if case == 'random'
                              else _matcher_case_claims())
    iouv = (0.5, 0.6, 0.75)
    got = match_device(torch.from_numpy(dets), torch.from_numpy(tgt),
                       torch.from_numpy(valid), w, h, iouv).numpy()
    want = np.asarray(jmatch(jnp.asarray(dets), jnp.asarray(tgt),
                             jnp.asarray(valid), w, h, iouv))
    assert got.dtype == bool and got.shape == dets.shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)
    host = _host_correct(dets, tgt, valid, w, h, np.asarray(iouv))
    for b, hb in enumerate(host):
        np.testing.assert_array_equal(got[b][dets[b][:, 4] > 0], hb)
    if case == 'claims':
        assert got[0, :7, 0].tolist() == [True, False, True, True, False,
                                          False, False]
        assert not got[1].any()
    else:
        assert 0 < got[..., 0].sum() < (dets[..., 4] > 0).sum()


def test_match_device_no_targets_and_argmax_ties():
    """T == 0 gives an all-False matrix; ``torch.argmax`` returns the first
    index among ties (the matcher's tie rule, as ``jnp.argmax``)."""
    from yolo_tpu_torch.eval.matching import match_device
    dets = torch.rand(2, 5, 6)
    out = match_device(dets, torch.zeros(0, 6), torch.zeros(0, dtype=bool),
                       64.0, 64.0, (0.5, 0.7))
    assert out.shape == (2, 5, 2) and not out.any()
    x = torch.tensor([[0.3, 0.7, 0.7, 0.1], [-1.0, -1.0, -1.0, -1.0]])
    assert x.argmax(1).tolist() == [1, 0]


# ------------------------------------------------------------ evaluate e2e

def _write_set(root, imgs, dets, names=('a', 'b')):
    """A labelled set on disk (PNG images, label txt files from each
    image's top-5 detections clipped to the image, a list txt, a .data)."""
    import cv2
    (root / 'images').mkdir(parents=True)
    (root / 'labels').mkdir()
    paths = []
    for i, (im, d) in enumerate(zip(imgs, dets)):
        p = root / 'images' / f'im{i}.png'
        cv2.imwrite(str(p), im[..., ::-1])          # RGB array -> BGR file
        rows = []
        for x1, y1, x2, y2, _, c in d[d[:, 4] > 0][:5]:
            x1, x2 = np.clip([x1, x2], 0, SIZE)
            y1, y2 = np.clip([y1, y2], 0, SIZE)
            rows.append(f'{int(c)} {(x1 + x2) / 2 / SIZE:.6f} '
                        f'{(y1 + y2) / 2 / SIZE:.6f} {(x2 - x1) / SIZE:.6f} '
                        f'{(y2 - y1) / SIZE:.6f}')
        (root / 'labels' / f'im{i}.txt').write_text('\n'.join(rows) + '\n')
        paths.append(str(p))
    (root / 'val.txt').write_text('\n'.join(paths))
    (root / 'toy.names').write_text('\n'.join(names) + '\n')
    data = root / 'toy.data'
    data.write_text(f'classes={len(names)}\nvalid={root}/val.txt\n'
                    f'names={root}/toy.names\n')
    return str(data)


@pytest.fixture(scope='module')
def eval_sets(tmp_path_factory):
    """{'float': (cfg, npz, data), 'quant': (cfg, npz, data)}: seeded
    weights in the JAX layout saved as .npz (the quantized one with the
    qstate of 3 google calibration steps), and a set labelled with that
    model's own top detections at conf 0.001, f32."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import qstate_to_jax, to_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    base = tmp_path_factory.mktemp('eval')
    imgs = images(11, N_IMAGES, SIZE)
    x = trt.preprocess(imgs, device='cpu')
    out = {}
    for name, text in (('float', TOY_CFG), ('quant', LEAKY_CFG)):
        cfg = str(base / f'{name}.cfg')
        (base / f'{name}.cfg').write_text(text)
        npz = str(base / f'{name}.npz')
        params, state = random_jax_weights(build_ir(cfg), seed=0)
        save_checkpoint(npz, params=params, state=state)
        if name == 'float':
            b = trt.load_model(cfg, npz, device='cpu',
                               dtype=torch.float32).fuse()
            infer = b.make_infer(conf_thres=0.001)
        else:
            b = trt.load_model(cfg, npz, device='cpu', quantized=1, steps=100)
            for _ in range(3):
                b.apply(x, train=True)
            jp, js = to_jax(b.net, b.params, b.state)
            save_checkpoint(npz, params=jp, state=js,
                            qstate=qstate_to_jax(b.qstate))
            infer = b.make_infer(conf_thres=0.001, engine=False)
        dets = infer(x).numpy()
        out[name] = (cfg, npz, _write_set(base / name, imgs, dets))
    return out


def _jax_weights(cfg, npz):
    """(net, params, state, qstate or None) of the JAX package from ``npz``."""
    from yolo_tpu.ir import build_ir
    from yolo_tpu.utils.checkpoint import load_checkpoint
    ck = load_checkpoint(npz)
    return build_ir(cfg), ck['params'], ck['state'], ck.get('qstate')


def _anchor_vecs(net):
    return [np.asarray(l.anchors, np.float32) / l.yolo_stride
            for l in net.layers if l.kind == 'yolo']


def _assert_results_close(got, want, what):
    (r, maps, _), (rj, mapsj, _) = got, want
    np.testing.assert_allclose(np.asarray(r), np.asarray(rj), **EVAL_TOL,
                               err_msg=what)
    np.testing.assert_allclose(maps, mapsj, **EVAL_TOL, err_msg=what)
    assert r[2] > 0.3, (what, r)


def test_evaluate_float_matches_jax(eval_sets):
    """The fused f32 float path with val losses, against JAX's evaluate;
    then the port's host matching and no-loss run against its own."""
    import jax.numpy as jnp
    from yolo_tpu.eval.evaluator import evaluate as jeval
    from yolo_tpu.models.network import fuse_params as jfuse
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.eval.evaluator import evaluate
    from yolo_tpu_torch.train.loss import LossHyp
    cfg, npz, data = eval_sets['float']
    jnet, jparams, jstate, _ = _jax_weights(cfg, npz)
    tb = trt.load_model(cfg, npz, device='cpu', dtype=torch.float32).fuse()
    avecs = _anchor_vecs(tb.net)
    kw = dict(batch_size=BS, img_size=SIZE, fused=True)
    want = jeval(jnet, jfuse(jnet, jparams, jstate), {}, data,
                 compute_dtype=jnp.float32, loss_hyp=JHyp(),
                 anchor_vecs=avecs, **kw)
    run = lambda **k: evaluate(tb.net, tb.params, tb.state, data,
                               compute_dtype=torch.float32, device='cpu',
                               **kw, **k)
    got = run(loss_hyp=LossHyp(), anchor_vecs=avecs)
    _assert_results_close(got, want, 'float')
    assert all(np.isfinite(got[0][4:])) and min(got[0][4:]) > 0
    host = run(loss_hyp=LossHyp(), anchor_vecs=avecs, device_match=False)
    assert host[0] == got[0]
    np.testing.assert_array_equal(host[1], got[1])
    plain = run()
    assert plain[0][:4] == got[0][:4] and plain[0][4:] == (0.0, 0.0, 0.0)


def test_evaluate_sparse_float_matches_jax(eval_sets):
    """``sparse=True`` (the sparse-decode NMS from the raw head maps, cell
    mode) against JAX's sparse evaluate on the same set."""
    import jax.numpy as jnp
    from yolo_tpu.eval.evaluator import evaluate as jeval
    from yolo_tpu.models.network import fuse_params as jfuse
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.eval.evaluator import evaluate
    cfg, npz, data = eval_sets['float']
    jnet, jparams, jstate, _ = _jax_weights(cfg, npz)
    tb = trt.load_model(cfg, npz, device='cpu', dtype=torch.float32).fuse()
    kw = dict(batch_size=BS, img_size=SIZE, fused=True, sparse=True)
    want = jeval(jnet, jfuse(jnet, jparams, jstate), {}, data,
                 compute_dtype=jnp.float32, **kw)
    got = evaluate(tb.net, tb.params, tb.state, data,
                   compute_dtype=torch.float32, device='cpu', **kw)
    _assert_results_close(got, want, 'sparse')


@pytest.mark.parametrize('path', ['sim', 'engine'])
def test_evaluate_quantized_matches_jax(eval_sets, path):
    """The QAT sim (JAX: its quant apply, hoisted by prepare_eval_params;
    the port: the sim directly) and the int8 engine (JAX: backend='xla',
    wired as test.py wires it; the port: int8_engine_apply, K2's twin on
    the CPU), with val losses."""
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.eval.evaluator import evaluate as jeval
    from yolo_tpu.models.int8_engine import make_int8_apply as jmake
    from yolo_tpu.models.int8_engine import prepare_int8 as jprepare
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.compress.quant import make_quant_apply
    from yolo_tpu_torch.eval.evaluator import evaluate, int8_engine_apply
    from yolo_tpu_torch.ops.conv_int8 import fused_conv_int8
    from yolo_tpu_torch.train.loss import LossHyp
    cfg, npz, data = eval_sets['quant']
    jnet, jparams, jstate, jqstate = _jax_weights(cfg, npz)
    jqcfg = JQ.QuantConfig(scheme='google', steps=100)
    tb = trt.load_model(cfg, npz, device='cpu', quantized=1, steps=100)
    avecs = _anchor_vecs(tb.net)
    kw = dict(batch_size=BS, img_size=SIZE, anchor_vecs=avecs)
    if path == 'sim':
        japply = JQ.make_quant_apply(jnet, jqcfg, compute_dtype=jnp.float32)
        jargs = (jparams, jstate, dict(quant_apply=japply, qstate=jqstate))
        targs = (tb.params, tb.state, dict(
            quant_apply=make_quant_apply(tb.net, tb.qcfg), qstate=tb.qstate))
    else:
        plan = jprepare(jnet, jparams, jstate, jqstate, jqcfg)
        eng = jmake(jnet, plan, backend='xla')
        jargs = (plan.arrays, {}, dict(
            quant_apply=lambda pa, st, qs, x, train: (*eng(pa, x), [])))
        arrays, qapply = int8_engine_apply(tb.net, tb.params, tb.state,
                                           tb.qstate, tb.qcfg, 'cpu')
        targs = (arrays, {}, dict(quant_apply=qapply))
    want = jeval(jnet, jargs[0], jargs[1], data, loss_hyp=JHyp(),
                 compute_dtype=jnp.float32, **jargs[2], **kw)
    n0 = fused_conv_int8.launches
    got = evaluate(tb.net, targs[0], targs[1], data, loss_hyp=LossHyp(),
                   device='cpu', **targs[2], **kw)
    assert fused_conv_int8.launches == n0       # the CPU runs K2's twin
    _assert_results_close(got, want, path)
    assert all(np.isfinite(got[0][4:])) and min(got[0][4:]) > 0
    if path == 'engine':        # the plan is prepared once per weights
        again = int8_engine_apply(tb.net, tb.params, tb.state, tb.qstate,
                                  tb.qcfg, 'cpu')
        assert again[0] is arrays


def test_eval_model_cache_follows_weights(eval_sets):
    """The cached Darknet is reused for the same tensors and rebuilt after
    an in-place update of one of them."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.eval.evaluator import eval_model
    cfg, npz, _ = eval_sets['float']
    tb = trt.load_model(cfg, npz, device='cpu', dtype=torch.float32).fuse()
    kw = dict(fused=True, compute_dtype=torch.float32, maxabsscaler=False,
              device='cpu')
    m = eval_model(tb.net, tb.params, tb.state, **kw)
    assert eval_model(tb.net, tb.params, tb.state, **kw) is m
    tb.params['0']['b'].add_(1.0)
    m2 = eval_model(tb.net, tb.params, tb.state, **kw)
    assert m2 is not m
    torch.testing.assert_close(m2.layer['0'].b, tb.params['0']['b'])


def test_cli_returns_what_evaluate_returns(eval_sets, tmp_path, monkeypatch):
    """``python -m yolo_tpu_torch.test --device cpu`` (bf16, the default
    dtype, with the batch-0 mosaics and results.json), then the benchmark
    task's sweep file."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch import test as cli
    from yolo_tpu_torch.eval.evaluator import evaluate
    cfg, npz, data = eval_sets['float']
    monkeypatch.chdir(tmp_path)
    argv = ['--cfg', cfg, '--data', data, '--weights', npz, '--device', 'cpu',
            '--img-size', str(SIZE), '--batch-size', str(BS)]
    got = cli.main(argv + ['--save-json'])
    tb = trt.load_model(cfg, npz, device='cpu').fuse()
    want = evaluate(tb.net, tb.params, tb.state, data, batch_size=BS,
                    img_size=SIZE, fused=True, device='cpu')[0]
    assert got == want and got[2] > 0.3
    for f in ('test_batch0_gt.jpg', 'test_batch0_pred.jpg', 'results.json'):
        assert (tmp_path / f).stat().st_size > 0, f
    rows = cli.main(argv + ['--task', 'benchmark', '--sweep-sizes', str(SIZE)])
    assert [r[:2] for r in rows] == [(SIZE, 0.6), (SIZE, 0.7)]
    assert np.loadtxt(tmp_path / 'benchmark.txt').shape == (2, 10)


def test_evaluate_augment_matches_jax(eval_sets, capsys):
    """``augment=True``: the float model's test-time augmentation into the
    dense NMS against JAX's ``evaluate(augment=True)``, with no val losses
    even when the loss is asked for; a quantized apply prints JAX's warning
    and runs its single pass."""
    import jax.numpy as jnp
    from yolo_tpu.eval.evaluator import evaluate as jeval
    from yolo_tpu.models.network import fuse_params as jfuse
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.compress.quant import make_quant_apply
    from yolo_tpu_torch.eval.evaluator import evaluate
    from yolo_tpu_torch.train.loss import LossHyp
    cfg, npz, data = eval_sets['float']
    jnet, jparams, jstate, _ = _jax_weights(cfg, npz)
    tb = trt.load_model(cfg, npz, device='cpu', dtype=torch.float32).fuse()
    avecs = _anchor_vecs(tb.net)
    kw = dict(batch_size=BS, img_size=SIZE, fused=True, augment=True,
              anchor_vecs=avecs)
    want = jeval(jnet, jfuse(jnet, jparams, jstate), {}, data,
                 compute_dtype=jnp.float32, loss_hyp=JHyp(), **kw)
    got = evaluate(tb.net, tb.params, tb.state, data, loss_hyp=LossHyp(),
                   compute_dtype=torch.float32, device='cpu', **kw)
    _assert_results_close(got, want, 'augment')
    assert got[0][4:] == (0.0, 0.0, 0.0)
    single = evaluate(tb.net, tb.params, tb.state, data, batch_size=BS,
                      img_size=SIZE, fused=True, compute_dtype=torch.float32,
                      device='cpu')
    assert got[0][:4] != single[0][:4]         # the three passes moved it
    qcfg, qnpz, qdata = eval_sets['quant']
    qb = trt.load_model(qcfg, qnpz, device='cpu', quantized=1, steps=100)
    qkw = dict(batch_size=BS, img_size=SIZE, device='cpu', qstate=qb.qstate,
               quant_apply=make_quant_apply(qb.net, qb.qcfg))
    capsys.readouterr()
    q_aug = evaluate(qb.net, qb.params, qb.state, qdata, augment=True, **qkw)
    assert 'WARNING: --augment (TTA) is not supported' in capsys.readouterr().out
    q_one = evaluate(qb.net, qb.params, qb.state, qdata, **qkw)
    assert q_aug[0] == q_one[0]
    np.testing.assert_array_equal(q_aug[1], q_one[1])


def test_unported_eval_paths_raise(eval_sets):
    """Mesh evaluation and ``--quantized 2`` raise NotImplementedError
    naming ROADMAP.md; test-time augmentation, which the first evaluation
    slice refused, runs, by ``evaluate`` and by the CLI's ``--augment``, to
    the same results. (``--qat-eval-snap bf16``, refused until the training
    slice, is held to JAX's in ``test_torch_eval_snap.py``.)"""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch import test as cli
    from yolo_tpu_torch.eval.evaluator import evaluate
    cfg, npz, data = eval_sets['float']
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        evaluate(None, {}, {}, data, device='cpu', mesh=object())
    base = ['--cfg', cfg, '--data', data, '--weights', npz, '--device', 'cpu']
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        cli.main(base + ['--quantized', '2'])
    with pytest.raises(SystemExit):
        cli.main(base + ['--int8-engine'])
    tb = trt.load_model(cfg, npz, device='cpu').fuse()
    want = evaluate(tb.net, tb.params, tb.state, data, batch_size=BS,
                    img_size=SIZE, fused=True, augment=True, device='cpu')[0]
    got = cli.main(base + ['--augment', '--no-plot', '--img-size', str(SIZE),
                           '--batch-size', str(BS)])
    assert got == want and got[2] > 0.3
