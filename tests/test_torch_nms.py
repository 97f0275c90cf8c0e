"""yolo_tpu_torch.ops.nms / nms_suppress against the JAX package.

The suppression twin must give the JAX kernel's (interpret mode) and XLA
path's ``keep`` exactly and their merged boxes within rtol 1e-5 / atol 1e-4
(different summation order in the merge). Whole-NMS outputs are held to the
same tolerance on identical inputs; the sparse-decode path also goes
through sigmoid/exp, whose last bits differ between the frameworks.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from _torch_port import candidates
from yolo_tpu.models.yolo_head import decode_yolo_nhwc as jdecode
from yolo_tpu.ops import nms as jnms
from yolo_tpu.ops.pallas_nms import suppress as jsuppress
from yolo_tpu_torch.ops import nms as tnms
from yolo_tpu_torch.ops import nms_suppress as K1
from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference

TOL = dict(rtol=1e-5, atol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize('max_sweeps', [0, 1, 3])
def test_suppress_reference_capped_chains_match_jax(max_sweeps):
    """A chain of 40 boxes, each overlapping only the next, spread over 96
    heavy-overlap candidates and capped below its length: the twin's
    unconverged ``keep`` equals the Pallas kernel's (interpret mode) and
    ``_suppress_xla``'s after exactly ``max_sweeps`` sweeps. This is the
    oracle that the cluster kernel's sweeps are held to on the card."""
    b, s, v = chip_smoke.candidate_arrays(
        np.random.default_rng(40 + max_sweeps), 2, 96, chain=40)
    b = np.where(v[..., None], b, 0).astype(np.float32)
    sv = (s * v).astype(np.float32)
    keep_p, merged_p = jsuppress(jnp.asarray(b), jnp.asarray(b),
                                 jnp.asarray(sv), jnp.asarray(v),
                                 iou_thres=0.6, max_sweeps=max_sweeps,
                                 merge=True, interpret=True)
    keep_x, merged_x = jax.vmap(
        lambda ob, bb, ss, vv: jnms._suppress_xla(ob, bb, ss, vv, 0.6, True,
                                                  max_sweeps)
    )(jnp.asarray(b), jnp.asarray(b), jnp.asarray(s), jnp.asarray(v))
    bt, st, vt = torch.from_numpy(b), torch.from_numpy(sv), torch.from_numpy(v)
    keep, merged = suppress_reference(bt, bt, st, vt, iou_thres=0.6,
                                      max_sweeps=max_sweeps)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_p))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_x))
    m = keep.numpy()[..., None]
    for ref in (merged_p, merged_x):
        np.testing.assert_allclose(np.where(m, merged.numpy(), 0),
                                   np.where(m, np.asarray(ref), 0), **TOL)
    # unconverged: more sweeps still change keep
    done = suppress_reference(bt, bt, st, vt, iou_thres=0.6, max_sweeps=64,
                              merge=False)[0]
    assert not torch.equal(keep, done)


@pytest.mark.parametrize('bs', [1, 8, 64])
def test_suppress_plan_covers_every_k(bs):
    """The cluster plan for every k the kernel takes, with and without the
    card holding bs clusters of 16: C = min(8 or 16, ceil(k / 32)) CTAs per
    image; the CTAs' column runs are whole 32-candidate words that cover
    0..k-1 exactly once, differ by at most one word and give each of the
    CTA's warps at most one word to sweep; shared memory within the
    H100's 227 KB and at least what the CTA keeps there."""
    for k in range(1, K1.MAX_K + 1):
        nw = -(-k // 32)
        for wide, c_max in ((0, 8), (bs - 1, 8), (bs, 16)):
            plan = K1.suppress_plan(bs, k, wide)
            assert plan.cluster == min(c_max, nw), (k, wide)
            assert plan.ctas == bs * plan.cluster
            assert len(plan.runs) == plan.cluster
            starts = [a for a, _ in plan.runs]
            ends = [b for _, b in plan.runs]
            assert starts[0] == 0 and starts[1:] == ends[:-1]
            assert ends[-1] - 32 < k <= ends[-1]
            widths = [b - a for a, b in plan.runs]
            assert all(a % 32 == 0 and b % 32 == 0 for a, b in plan.runs)
            assert min(widths) >= 32 and max(widths) - min(widths) <= 32
            assert max(widths) // 32 <= K1.THREADS // 32
            assert plan.smem == K1.smem_bytes(k, plan.cluster)
            assert (20 * 32 * nw + 20 * k + 4 * nw * max(widths) + 8 * nw
                    <= plan.smem <= K1.SMEM_LIMIT == 227 * 1024)


def _kernel_source_formulas():
    """The constants and the constexpr size functions of
    ``csrc/nms_suppress.cu`` as Python, read from the source."""
    with open(os.path.join(ROOT, 'yolo_tpu_torch', 'csrc',
                           'nms_suppress.cu')) as f:
        src = f.read()
    env = {}
    for name, expr in re.findall(r'^constexpr int (k\w+) = ([^;]+);', src,
                                 re.M):
        env[name] = eval(expr.replace('/', '//'), {}, env)
    for fn in ('words', 'run_words', 'smem_bytes'):
        m = re.search(r'constexpr int ' + fn + r'\(([^)]*)\) \{\s*return '
                      r'(.+?);\s*\}', src, re.S)
        params = [a.split()[-1] for a in m.group(1).split(',')]
        expr = ' '.join(m.group(2).split()).replace('/', '//')
        env[fn] = eval(f'lambda {", ".join(params)}: {expr}', env)
    return env, src


def test_suppress_smem_formula_matches_kernel_source():
    """The plan's shared-memory count and constants against the kernel
    source's, for every k and cluster size the kernel takes: the plan's
    CTAs get what the kernel asks for, and the kernel refuses what the
    plan would refuse."""
    env, src = _kernel_source_formulas()
    assert (env['kMaxK'], env['kThreads'], env['kMaxCluster'],
            env['kSmemLimit']) == (K1.MAX_K, K1.THREADS, K1.CLUSTER_MAX,
                                   K1.SMEM_LIMIT)
    assert 'smem_bytes(k, cluster) <= kSmemLimit' in src
    assert 'run_words(k, cluster) <= kWarps' in src
    for k in range(1, K1.MAX_K + 1):
        assert env['words'](k) == K1.words(k)
        for c in range(1, min(K1.CLUSTER_MAX, K1.words(k)) + 1):
            assert K1.smem_bytes(k, c) == env['smem_bytes'](k, c), (k, c)


def _kernel_float_constants(src):
    """The ``constexpr float`` constants of the kernel source as floats."""
    out = {}
    for name, expr in re.findall(r'^constexpr float (k\w+) = ([^;]+);', src,
                                 re.M):
        expr = re.sub(r'(0x[0-9a-fA-Fp.+-]+)f\b',
                      lambda m: repr(float.fromhex(m.group(1))), expr)
        out[name] = float(eval(re.sub(r'(\d)f\b', r'\1', expr)))
    return out


def test_division_free_threshold_test_is_exact():
    """The kernel's test of iou > thres without the division (graph_word
    in ``csrc/nms_suppress.cu``: decided from p = RN(thres * den) unless
    inter lies within p * (1 -+ 2^-18)), in numpy float32 with the
    kernel's constants, against RN(inter / den) > thres as the plain
    version computes it. Half the pairs are random boxes, half are built
    to sit within 2 ulp of the threshold. The kernel cannot run here; this
    holds its rule, and that the rule decides most random pairs."""
    _, src = _kernel_source_formulas()
    c = _kernel_float_constants(src)
    f = np.float32
    up, down, eps = f(c['kUp']), f(c['kDown']), f(c['kEps'])
    assert (up, down) == (f(1 + 2 ** -18), f(1 - 2 ** -18))
    rng = np.random.default_rng(0)
    n = 200_000
    for thres in (0.3, 0.45, 0.5, 0.6, 0.7, 0.9):
        th = f(thres)
        a = rng.uniform(0, 300, (n, 4)).astype(f)
        a[:, 2:] = a[:, :2] + rng.uniform(0, 80, (n, 2)).astype(f)
        b = rng.uniform(0, 300, (n, 4)).astype(f)
        b[:, 2:] = b[:, :2] + rng.uniform(0, 80, (n, 2)).astype(f)
        # equal boxes shifted along x by s: iou = (w - s) / (w + s) = thres
        m = n // 2
        s = ((a[:m, 2] - a[:m, 0]) * (1 - thres) / (1 + thres)).astype(f)
        b[:m] = a[:m]
        b[:m, 0] += s + rng.integers(-2, 3, m) * np.spacing(a[:m, 0])
        b[:m, 2] += s
        b[:m, 2] = np.maximum(b[:m, 2], b[:m, 0])
        iw = np.maximum(np.minimum(a[:, 2], b[:, 2])
                        - np.maximum(a[:, 0], b[:, 0]), f(0))
        ih = np.maximum(np.minimum(a[:, 3], b[:, 3])
                        - np.maximum(a[:, 1], b[:, 1]), f(0))
        inter = iw * ih
        area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        den = area_a + area_b - inter + eps
        assert inter.dtype == den.dtype == np.float32
        assert (area_a <= c['kMaxArea']).all() and (den >= c['kTiny']).all()
        ref = inter / den > th
        p = th * den
        over = inter >= p * up
        sure = over | (inter <= p * down)
        np.testing.assert_array_equal(np.where(sure, over, ref), ref)
        assert (~sure[:m]).mean() > 0.5     # the division path is taken
        assert sure[m:].mean() > 0.99


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
