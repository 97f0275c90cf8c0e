"""The PyTorch port's float detection slice against the JAX package.

CPU tests: ``load_model -> fuse -> make_infer`` of ``yolo_tpu_torch`` on a
toy cfg, with the JAX bundle's weights carried across by
``yolo_tpu_torch.convert.from_jax``, dense and sparse, against
``yolo_tpu.runtime``; and a subprocess check that the port never imports jax.

Tests marked ``gpu`` hold the CUDA kernels against their plain PyTorch
versions on the card and skip without one. This module imports no jax at
the top, so those run on a machine without jax:
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_slice.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, candidates, images, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(scope='module', autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    # f32 comparisons on the card: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.fixture(scope='module')
def toy_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp('cfg') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return str(p)


@pytest.fixture(scope='module')
def toy_checkpoint(toy_cfg, tmp_path_factory):
    """Seeded weights in the JAX layout, as .npz and darknet .weights."""
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.darknet_io import save_darknet_weights
    from yolo_tpu.utils.checkpoint import save_checkpoint
    net = build_ir(toy_cfg)
    params, state = random_jax_weights(net, seed=21, conv_scale=1.0)
    d = tmp_path_factory.mktemp('ckpt')
    save_checkpoint(d / 'toy.npz', params=params, state=state)
    save_darknet_weights(net, params, state, d / 'toy.weights')
    return params, state, str(d / 'toy.npz'), str(d / 'toy.weights')


@pytest.mark.parametrize('sparse', [False, True])
def test_slice_matches_jax_bundle(toy_cfg, toy_checkpoint, sparse):
    """load_model -> fuse -> make_infer of the port against the JAX bundle
    with the same weights, f32 on both sides (JAX at 'highest' precision).
    Tolerance rtol/atol 1e-4: the forwards differ in summation order."""
    import jax
    from yolo_tpu import runtime as jrt
    from yolo_tpu_torch import runtime as trt
    params, state, npz, _ = toy_checkpoint
    old = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    try:
        jb = jrt.load_model(toy_cfg, npz, compute_dtype=None).fuse()
        kw = dict(conf_thres=0.05, iou_thres=0.5, top_k=128, max_det=64,
                  sparse=sparse)
        x = images(5, 2, 64)
        ref = np.asarray(jb.make_infer(**kw)(jrt.preprocess(x)))
    finally:
        jax.config.update('jax_default_matmul_precision', old)
    tb = trt.load_model(toy_cfg, npz, device='cpu', dtype=torch.float32).fuse()
    got = tb.make_infer(**kw)(trt.preprocess(x, device='cpu'))
    assert got.shape == ref.shape == (2, 64, 6)
    assert (ref[..., 4] > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_weights_and_npz_load_the_same_model(toy_cfg, toy_checkpoint):
    from yolo_tpu_torch import runtime as trt
    _, _, npz, weights = toy_checkpoint
    a = trt.load_model(toy_cfg, npz, device='cpu', dtype=torch.float32)
    b = trt.load_model(toy_cfg, weights, device='cpu', dtype=torch.float32)
    for tree_a, tree_b in ((a.params, b.params), (a.state, b.state)):
        assert tree_a.keys() == tree_b.keys()
        for k in tree_a:
            if a.net.layers[int(k)].kind == 'shortcut':
                continue        # .weights files carry no shortcut weights
            for f in tree_a[k]:
                assert torch.equal(tree_a[k][f], tree_b[k][f]), (k, f)


def test_npz_with_ema_loads_the_ema_pair(toy_cfg, toy_checkpoint, tmp_path):
    """A training checkpoint with an EMA copy serves the EMA params and BN
    state, as the JAX package's load_model does."""
    from yolo_tpu import runtime as jrt
    from yolo_tpu.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import from_jax
    params, state = toy_checkpoint[:2]
    ema = {k: {f: a * 0.5 for f, a in d.items()} for k, d in params.items()}
    ema_state = {k: {f: a + 0.25 for f, a in d.items()}
                 for k, d in state.items()}
    path = tmp_path / 'ema.npz'
    save_checkpoint(path, params=params, state=state, ema=ema,
                    ema_state=ema_state)
    got = trt.load_model(toy_cfg, str(path), device='cpu',
                         dtype=torch.float32)
    ref = jrt.load_model(toy_cfg, str(path), compute_dtype=None)
    want_p, want_s = from_jax(got.net, ref.params, ref.state)
    for k in want_p:
        for f in want_p[k]:
            assert torch.equal(got.params[k][f], want_p[k][f]), (k, f)
    for k in want_s:
        for f in want_s[k]:
            assert torch.equal(got.state[k][f], want_s[k][f]), (k, f)
    assert torch.equal(got.state['0']['mean'],
                       torch.from_numpy(ema_state['0']['mean']))


def test_default_decode_is_dense(toy_cfg, toy_checkpoint):
    from yolo_tpu_torch import runtime as trt
    b = trt.load_model(toy_cfg, toy_checkpoint[2], device='cpu',
                       dtype=torch.float32).fuse()
    x = trt.preprocess(images(6, 1, 64), device='cpu')
    kw = dict(conf_thres=0.05, max_det=32)
    assert torch.equal(b.make_infer(**kw)(x), b.make_infer(sparse=False, **kw)(x))


def test_preprocess_matches_jax():
    from yolo_tpu.runtime import preprocess as jpre
    from yolo_tpu_torch.runtime import preprocess
    x = images(7, 2, 32)
    for maxabs in (False, True):
        got = preprocess(x, maxabs, device='cpu')
        assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jpre(x, maxabs)))


def test_bf16_pipeline_tracks_f32(toy_cfg, toy_checkpoint):
    """The bf16 forward (the default dtype) stays close to the f32 one."""
    from yolo_tpu_torch import runtime as trt
    x = trt.preprocess(images(8, 2, 64), device='cpu')
    heads = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = trt.load_model(toy_cfg, toy_checkpoint[2], device='cpu',
                           dtype=dtype).fuse().model()
        with torch.no_grad():
            heads[dtype] = [h.float() for h in m.forward_heads(x)[0]]
    for a, b in zip(heads[torch.float32], heads[torch.bfloat16]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.05, atol=0.1)


def test_unported_paths_raise(toy_cfg, toy_checkpoint, tmp_path):
    """Other quantization schemes raise NotImplementedError naming
    ROADMAP.md; a .pt checkpoint and test-time augmentation, which the
    first slice refused, now serve: the .pt (written by the JAX package's
    ``save_torch_checkpoint``) loads the weights the .npz loads, and
    ``make_infer(augment=True)`` returns detections."""
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.torch_import import save_torch_checkpoint
    from yolo_tpu_torch import runtime as trt
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.load_model(toy_cfg, device='cpu', quantized=2)
    params, state, npz, _ = toy_checkpoint
    pt = tmp_path / 'm.pt'
    save_torch_checkpoint(build_ir(toy_cfg), params, state, pt)
    a = trt.load_model(toy_cfg, str(pt), device='cpu', dtype=torch.float32)
    b = trt.load_model(toy_cfg, npz, device='cpu', dtype=torch.float32)
    for k in b.params:
        for f in b.params[k]:
            assert torch.equal(a.params[k][f], b.params[k][f]), (k, f)
    x = trt.preprocess(images(9, 2, 64), device='cpu')
    dets = a.fuse().make_infer(augment=True, conf_thres=0.05)(x)
    assert dets.shape == (2, 300, 6) and int((dets[..., 4] > 0).sum()) > 0


def test_port_never_imports_jax_or_cv2():
    """Importing every module of the port (the evaluation path's included)
    loads neither jax, nor OpenCV or PIL (imported inside functions only),
    nor any module of the JAX package."""
    code = ('import pkgutil, importlib, sys, yolo_tpu_torch; '
            'mods = [m.name for m in pkgutil.walk_packages('
            "yolo_tpu_torch.__path__, 'yolo_tpu_torch.')]; "
            '[importlib.import_module(m) for m in mods]; '
            "assert len(mods) > 25, mods; "
            "need = {'yolo_tpu_torch.' + m for m in ('eval.evaluator', "
            "'eval.matching', 'eval.metrics', 'train.loss', "
            "'data.datasets', 'data.transforms', 'utils.plots', 'test', "
            "'compress.prune', 'compress.prune_drivers', "
            "'compress.prune_cli', 'prune', 'info', 'utils.profiling')}; "
            "assert need <= set(mods), need - set(mods); "
            "assert 'PIL' not in sys.modules; "
            "bad = [m for m in sys.modules if m in ('jax', 'cv2') "
            "or m == 'yolo_tpu' or m.startswith(('jax.', 'yolo_tpu.'))]; "
            'assert not bad, bad')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                   check=True, timeout=120)


# ---------------------------------------------------------------- on the card

def _suppress_inputs(arrays, dev):
    """Numpy (boxes, scores, valid) on ``dev`` as ``_suppress_and_finalize``
    hands them to the kernel: invalid rows zeroed, scores times valid."""
    b, s, v = arrays
    valid = torch.from_numpy(v).to(dev)
    boxes = torch.where(valid[..., None], torch.from_numpy(b).to(dev), 0.0)
    return boxes.contiguous(), (torch.from_numpy(s).to(dev) * valid), valid


def _assert_suppress_matches(got, ref):
    """keep bit-equal; merged within rtol 1e-5 / atol 1e-4 where kept (the
    kernel sums the merge in another order)."""
    assert torch.equal(got[0], ref[0])
    m = got[0][..., None]
    torch.testing.assert_close(torch.where(m, got[1], 0.0),
                               torch.where(m, ref[1], 0.0),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize('k', [1, 31, 32, 33, 65, 256, 300, 512, 1000, 1024])
@pytest.mark.parametrize('merge', [True, False])
def test_suppress_kernel_matches_reference(cuda, k, merge):
    from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference
    boxes, scores, valid = _suppress_inputs(
        candidates(np.random.default_rng(k), 8, k), cuda)
    n0 = suppress.launches
    got = suppress(boxes, boxes, scores, valid, iou_thres=0.6, merge=merge)
    torch.cuda.synchronize()
    assert suppress.launches == n0 + 1
    ref = suppress_reference(boxes, boxes, scores, valid, iou_thres=0.6,
                             merge=merge)
    _assert_suppress_matches(got, ref)
    if k >= 64:
        assert 0 < int(got[0].sum()) < int(valid.sum())


@pytest.mark.gpu
@pytest.mark.parametrize('bs', [1, 64])
@pytest.mark.parametrize('k', [512, 1000])
def test_suppress_kernel_batch_sizes(cuda, bs, k):
    """One image, and more clusters than the card holds at once."""
    from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference
    boxes, scores, valid = _suppress_inputs(
        candidates(np.random.default_rng(bs * k), bs, k), cuda)
    got = suppress(boxes, boxes, scores, valid, iou_thres=0.6)
    torch.cuda.synchronize()
    _assert_suppress_matches(got, suppress_reference(
        boxes, boxes, scores, valid, iou_thres=0.6))


@pytest.mark.gpu
@pytest.mark.parametrize('max_sweeps', [0, 1, 3, 16])
@pytest.mark.parametrize('bs,k,merge', [(8, 512, True), (64, 1024, False)])
def test_suppress_kernel_capped_chains(cuda, max_sweeps, bs, k, merge):
    """A chain of 40 boxes, each overlapping only the next, spread over the
    cluster's CTAs: below the chain's length the sweeps stop unconverged,
    and ``keep`` must still equal the plain version's exactly
    ``max_sweeps`` sweeps."""
    import chip_smoke
    from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference
    boxes, scores, valid = _suppress_inputs(chip_smoke.candidate_arrays(
        np.random.default_rng(max_sweeps), bs, k, chain=40), cuda)
    kw = dict(iou_thres=0.6, max_sweeps=max_sweeps, merge=merge)
    got = suppress(boxes, boxes, scores, valid, **kw)
    torch.cuda.synchronize()
    ref = suppress_reference(boxes, boxes, scores, valid, **kw)
    _assert_suppress_matches(got, ref)
    if max_sweeps in (1, 3):       # not yet the greedy result
        assert not torch.equal(ref[0], suppress_reference(
            boxes, boxes, scores, valid, iou_thres=0.6, max_sweeps=64,
            merge=False)[0])


@pytest.mark.gpu
@pytest.mark.parametrize('cluster', [1, 2, 4, 8, 16])
def test_suppress_kernel_every_cluster_size(cuda, cluster):
    """The kernel at each cluster size it takes (k=512: 16 words over 1 to
    16 CTAs), and the plan's choice at k=512, bs=8."""
    import chip_smoke
    from yolo_tpu_torch.ops import nms_suppress as K1
    boxes, scores, valid = _suppress_inputs(chip_smoke.candidate_arrays(
        np.random.default_rng(5), 8, 512, chain=40), cuda)
    out = (torch.empty_like(valid), torch.empty_like(boxes))
    K1._launch(boxes, boxes, scores, valid, *out, 0.6, 16, True, cluster)
    torch.cuda.synchronize()
    _assert_suppress_matches(out, K1.suppress_reference(
        boxes, boxes, scores, valid, iou_thres=0.6))
    plan = K1.device_plan(8, 512, torch.cuda.current_device())
    assert plan.cluster >= 4 and plan.ctas >= 32


@pytest.mark.gpu
def test_suppress_kernel_edge_cases(cuda):
    from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference
    # no valid candidate
    z = torch.zeros((2, 128, 4), device=cuda)
    keep, merged = suppress(z, z, torch.zeros((2, 128), device=cuda),
                            torch.zeros((2, 128), dtype=torch.bool,
                                        device=cuda), iou_thres=0.6)
    assert not bool(keep.any()) and bool(torch.isfinite(merged).all())
    # iou exactly at the threshold (2 / 4 = 0.5) suppresses nothing, and a
    # larger overlap suppresses the lower-scored box
    b = torch.tensor([[[0, 0, 4, 1], [0, 0, 2, 1], [10, 10, 14, 14],
                       [10, 10, 14, 13.5]]], dtype=torch.float32, device=cuda)
    s = torch.tensor([[0.9, 0.8, 0.7, 0.6]], device=cuda)
    v = torch.ones((1, 4), dtype=torch.bool, device=cuda)
    keep, _ = suppress(b, b, s, v, iou_thres=0.5)
    keep_r, _ = suppress_reference(b, b, s, v, iou_thres=0.5)
    assert keep.tolist() == keep_r.tolist() == [[True, True, True, False]]
    with pytest.raises(ValueError):
        suppress(b, b, s.double(), v, iou_thres=0.5)
    # boxes that are not 16-byte aligned (a view one float in) are copied
    flat = torch.zeros(1 + 2 * 33 * 4, device=cuda)
    bb, ss, vv = _suppress_inputs(candidates(np.random.default_rng(3), 2, 33),
                                  cuda)
    odd = flat[1:].view(2, 33, 4)
    odd.copy_(bb)
    _assert_suppress_matches(
        suppress(odd, odd, ss, vv, iou_thres=0.45),
        suppress_reference(bb, bb, ss, vv, iou_thres=0.45))
    # a cluster the kernel does not take is refused, not launched
    from yolo_tpu_torch.ops.nms_suppress import _launch
    out = (torch.empty_like(vv), torch.empty_like(bb))
    with pytest.raises(RuntimeError, match='plan'):
        _launch(bb, bb, ss, vv, *out, 0.5, 16, True, 4)   # 33 is two words
    z = torch.zeros((1, 1025, 4), device=cuda)
    with pytest.raises(ValueError, match='1025'):
        suppress(z, z, torch.zeros((1, 1025), device=cuda),
                 torch.zeros((1, 1025), dtype=torch.bool, device=cuda),
                 iou_thres=0.5)


@pytest.mark.gpu
def test_slice_on_card_matches_cpu(cuda, toy_cfg):
    """The whole pipeline in f32 (TF32 off) on the card, through the NMS
    kernel, against the same pipeline on the CPU through the plain twin."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.ops.nms_suppress import suppress
    bundles = {d: trt.load_model(toy_cfg, device=d, dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(0)
                                 ).fuse() for d in ('cpu', cuda)}
    x = images(3, 2, 64)
    for sparse, classes in ((False, None), (True, None), (True, (1,))):
        kw = dict(conf_thres=0.01, iou_thres=0.5, top_k=128, max_det=64,
                  sparse=sparse, classes=classes)
        ref = bundles['cpu'].make_infer(**kw)(trt.preprocess(x, device='cpu'))
        n0 = suppress.launches
        got = bundles[cuda].make_infer(**kw)(trt.preprocess(x, device=cuda))
        torch.cuda.synchronize()
        assert suppress.launches == n0 + 1
        assert int((ref[..., 4] > 0).sum()) > 0
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)
