"""yolo_tpu_torch.ops.nms / nms_suppress against the JAX package.

The suppression twin must give the JAX kernel's (interpret mode) and XLA
path's ``keep`` exactly and their merged boxes within rtol 1e-5 / atol 1e-4
(different summation order in the merge). Whole-NMS outputs are held to the
same tolerance on identical inputs; the sparse-decode path also goes
through sigmoid/exp, whose last bits differ between the frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import candidates
from yolo_tpu.models.yolo_head import decode_yolo_nhwc as jdecode
from yolo_tpu.ops import nms as jnms
from yolo_tpu.ops.pallas_nms import suppress as jsuppress
from yolo_tpu_torch.ops import nms as tnms
from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope='module', autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize('k', [128, 100])
@pytest.mark.parametrize('merge', [True, False])
def test_suppress_reference_matches_jax(k, merge):
    b, s, v = candidates(np.random.default_rng(k), 2, k)
    b = np.where(v[..., None], b, 0).astype(np.float32)
    sv = (s * v).astype(np.float32)
    keep_p, merged_p = jsuppress(jnp.asarray(b), jnp.asarray(b),
                                 jnp.asarray(sv), jnp.asarray(v),
                                 iou_thres=0.6, merge=merge, interpret=True)
    keep_x, merged_x = jax.vmap(
        lambda ob, bb, ss, vv: jnms._suppress_xla(ob, bb, ss, vv, 0.6, merge, 16)
    )(jnp.asarray(b), jnp.asarray(b), jnp.asarray(s), jnp.asarray(v))
    bt = torch.from_numpy(b)
    keep, merged = suppress(bt, bt, torch.from_numpy(sv), torch.from_numpy(v),
                            iou_thres=0.6, merge=merge)
    assert 0 < int(keep.sum()) < int(v.sum())
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_p))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_x))
    m = keep.numpy()[..., None]
    for ref in (merged_p, merged_x):
        np.testing.assert_allclose(np.where(m, merged.numpy(), 0),
                                   np.where(m, np.asarray(ref), 0), **TOL)


def test_suppress_cpu_uses_reference_and_counts_no_launch():
    b, s, v = candidates(np.random.default_rng(0), 1, 64)
    bt, st, vt = map(torch.from_numpy, (b, s * v, v))
    n0 = suppress.launches
    got = suppress(bt, bt, st, vt, iou_thres=0.5, max_sweeps=3)
    ref = suppress_reference(bt, bt, st, vt, iou_thres=0.5, max_sweeps=3)
    assert suppress.launches == n0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_suppress_no_validcandidates():
    z = torch.zeros((1, 128, 4))
    keep, merged = suppress(z, z, torch.zeros((1, 128)),
                            torch.zeros((1, 128), dtype=torch.bool),
                            iou_thres=0.6)
    assert not bool(keep.any()) and bool(torch.isfinite(merged).all())


def _dense_pred(seed, bs=2, n=800, nc=8):
    rng = np.random.default_rng(seed)
    pred = np.zeros((bs, n, 5 + nc), np.float32)
    pred[..., 0:2] = rng.uniform(50, 350, (bs, n, 2))
    pred[..., 2:4] = rng.uniform(1, 80, (bs, n, 2))      # some fail MIN_WH
    pred[..., 4] = rng.uniform(0, 1, (bs, n))
    pred[..., 5:] = rng.uniform(0, 1, (bs, n, nc))
    pred[0, 3, 0] = np.inf                               # non-finite box
    pred[1, 5, 7] = np.nan                               # non-finite class
    return pred


NMS_CASES = {
    'default': dict(conf_thres=0.3, top_k=256),
    'agnostic': dict(conf_thres=0.3, top_k=128, agnostic=True),
    'single_label': dict(conf_thres=0.2, top_k=256, multi_label=False),
    'classes': dict(conf_thres=0.3, top_k=128, classes=(1, 4)),
    'no_merge': dict(conf_thres=0.3, top_k=64, merge=False, max_det=32),
    'small_n': dict(conf_thres=0.05, top_k=512, max_det=400),
}


@pytest.mark.parametrize('case', sorted(NMS_CASES))
def test_non_max_suppression_matches_jax(case):
    kw = NMS_CASES[case]
    pred = _dense_pred(11)
    if case == 'small_n':
        pred = pred[:, :40]              # box_k < 256 and max_det > k paths
    ref = np.asarray(jnms.non_max_suppression(jnp.asarray(pred), **kw))
    got = tnms.non_max_suppression(torch.from_numpy(pred), **kw)
    assert got.shape == ref.shape
    assert (ref[..., 4] > 0).sum() > 4
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    plain = tnms.non_max_suppression(torch.from_numpy(pred), plain=True, **kw)
    assert torch.equal(plain, got)


def _heads(seed, bs=2, nc=4, na=3):
    """Raw NHWC head maps with a sprinkle of confident boxes."""
    rng = np.random.default_rng(seed)
    no = nc + 5
    shapes = [(8, 8, 32), (16, 16, 16)]
    anchors = [np.array([[80, 90], [120, 60], [200, 200]], np.float32),
               np.array([[20, 30], [40, 25], [60, 60]], np.float32)]
    heads = []
    for ny, nx, _ in shapes:
        x = rng.uniform(-9, -5, (bs, ny, nx, na * no)).astype(np.float32)
        for b in range(bs):
            for _ in range(12):
                yy, xx, aa = rng.integers(ny), rng.integers(nx), rng.integers(na)
                base = aa * no
                x[b, yy, xx, base:base + 4] = rng.uniform(-1, 1, 4)
                x[b, yy, xx, base + 4] = rng.uniform(2.0, 5.0)
                x[b, yy, xx, base + 5 + rng.integers(nc)] = rng.uniform(2, 5)
        heads.append(x)
    return heads, anchors, [s for _, _, s in shapes], no


@pytest.mark.parametrize('mode', ['row', 'cell', 'mixed'])
@pytest.mark.parametrize('classes', [None, (0, 2)])
def test_non_max_suppression_heads_matches_jax(mode, classes):
    heads, anchors, strides, no = _heads(3)
    objs = {'row': None,
            'cell': [h[..., 4::no] for h in heads],
            'mixed': [heads[0][..., 4::no], None]}[mode]
    kw = dict(conf_thres=0.3, iou_thres=0.5, top_k=64, max_det=32,
              classes=classes)
    ref = np.asarray(jax.jit(lambda hs, os_: jnms.non_max_suppression_heads(
        hs, anchors, strides, no, objs=os_, **kw))(
        [jnp.asarray(h) for h in heads],
        None if objs is None else [None if o is None else jnp.asarray(o)
                                   for o in objs]))
    got = tnms.non_max_suppression_heads(
        [torch.from_numpy(h) for h in heads], anchors, strides, no,
        objs=None if objs is None else [None if o is None else
                                        torch.from_numpy(o.copy())
                                        for o in objs], **kw)
    assert (ref[..., 4] > 0).sum() > 8
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # and the sparse decode equals the dense decode of the same heads
    io = torch.cat([torch.from_numpy(np.array(jdecode(jnp.asarray(h), a, s,
                                                      no)))
                    for h, a, s in zip(heads, anchors, strides)], 1)
    dense = tnms.non_max_suppression(io, **kw)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fixpoint_equals_sequential_greedy():
    rng = np.random.RandomState(0)
    for trial in range(5):
        n = 60
        centers = rng.uniform(50, 450, (n, 2))
        sizes = rng.uniform(20, 120, (n, 2))
        obj = rng.uniform(0.2, 1.0, n)
        pred = np.zeros((1, n, 6), np.float32)            # nc = 1
        pred[0, :, 0:2] = centers
        pred[0, :, 2:4] = sizes
        pred[0, :, 4] = obj
        pred[0, :, 5] = 1.0
        out = tnms.to_host_detections(tnms.non_max_suppression(
            torch.from_numpy(pred), conf_thres=0.1, iou_thres=0.5, top_k=64,
            max_det=64, merge=False, multi_label=False))
        p = pred[0]
        boxes = np.concatenate([p[:, :2] - p[:, 2:4] / 2,
                                p[:, :2] + p[:, 2:4] / 2], 1)

        def iou(a, b):
            wh = np.clip(np.minimum(a[2:], b[2:]) - np.maximum(a[:2], b[:2]),
                         0, None)
            inter = wh[0] * wh[1]
            area = lambda x: (x[2] - x[0]) * (x[3] - x[1])
            return inter / (area(a) + area(b) - inter + 1e-16)

        kept = []
        for i in np.argsort(-p[:, 4], kind='stable'):
            if all(iou(boxes[i], boxes[j]) <= 0.5 for j in kept):
                kept.append(i)
        expect = np.sort(p[kept, 4])[::-1]
        got = np.sort(out[0][:, 4])[::-1]
        np.testing.assert_allclose(got, expect, rtol=1e-6,
                                   err_msg=f'trial {trial}')


def test_tied_scores_keep_lower_index_first():
    """Equal scores: the lower candidate index ranks first at every top-k,
    so tie order (and thus the greedy order and the output slots) is the
    same on every device. JAX's CPU approx_max_k keeps that order only
    while k < n (with k == n it returns e.g. [30, 21, 22, ...]), so the JAX
    comparison uses more boxes than its first-stage buffer of 256."""
    n = 300
    pred = np.zeros((1, n, 6), np.float32)
    pred[0, :, 0] = 20 + 30 * (np.arange(n) % 20)    # disjoint 20 x 15 grid
    pred[0, :, 1] = 20 + 30 * (np.arange(n) // 20)
    pred[0, :, 2:4] = 20
    pred[0, :, 4] = 0.75                       # every score ties
    pred[0, :, 5] = 0.75
    kw = dict(conf_thres=0.1, iou_thres=0.5, top_k=16, max_det=10)
    got = tnms.non_max_suppression(torch.from_numpy(pred), **kw)[0]
    ref = np.asarray(jnms.non_max_suppression(jnp.asarray(pred), **kw))[0]
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(got[:, 0].numpy(), 10 + 30 * np.arange(10))
    # with fewer boxes than the buffer the port still takes index order
    got = tnms.non_max_suppression(torch.from_numpy(pred[:, :40]), **kw)[0]
    np.testing.assert_allclose(got[:, 0].numpy(), 10 + 30 * np.arange(10))
    # heads path: tied objectness logits across cells
    h = np.full((1, 4, 4, 6), -9.0, np.float32)        # na=1, nc=1
    h[..., 4] = 1.0
    h[..., 5] = 3.0
    args = ([torch.from_numpy(h)], [np.array([[30, 30]], np.float32)], [32], 6)
    got = tnms.non_max_suppression_heads(*args, conf_thres=0.1, top_k=4,
                                         max_det=4)
    ref = np.asarray(jnms.non_max_suppression_heads(
        [jnp.asarray(h)], *args[1:], conf_thres=0.1, top_k=4, max_det=4))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_to_host_detections_and_empty():
    out = tnms.to_host_detections(
        tnms.non_max_suppression(torch.zeros((2, 16, 8))))
    assert out == [None, None]
    d = torch.zeros((1, 3, 6))
    d[0, 1] = torch.tensor([1, 2, 3, 4, 0.9, 2])
    got = tnms.to_host_detections(d)
    assert got[0].shape == (1, 6) and got[0][0, 5] == 2
