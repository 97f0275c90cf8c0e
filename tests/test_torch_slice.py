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


def test_unported_paths_raise(toy_cfg, tmp_path):
    from yolo_tpu_torch import runtime as trt
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.load_model(toy_cfg, device='cpu', quantized=2)
    pt = tmp_path / 'm.pt'
    pt.write_bytes(b'')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.load_model(toy_cfg, str(pt), device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.load_model(toy_cfg, device='cpu').fuse().make_infer(augment=True)


def test_port_never_imports_jax_or_cv2():
    """Importing every module of the port loads neither jax, nor OpenCV
    (imported inside functions only), nor any module of the JAX package."""
    code = ('import pkgutil, importlib, sys, yolo_tpu_torch; '
            'mods = [m.name for m in pkgutil.walk_packages('
            "yolo_tpu_torch.__path__, 'yolo_tpu_torch.')]; "
            '[importlib.import_module(m) for m in mods]; '
            "assert len(mods) > 20, mods; "
            "bad = [m for m in sys.modules if m in ('jax', 'cv2') "
            "or m == 'yolo_tpu' or m.startswith(('jax.', 'yolo_tpu.'))]; "
            'assert not bad, bad')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                   check=True, timeout=120)


# ---------------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize('k', [512, 300, 256])
@pytest.mark.parametrize('merge', [True, False])
def test_suppress_kernel_matches_reference(cuda, k, merge):
    from yolo_tpu_torch.ops.nms_suppress import suppress, suppress_reference
    b, s, v = candidates(np.random.default_rng(k), 8, k)
    boxes = torch.from_numpy(b).to(cuda)
    valid = torch.from_numpy(v).to(cuda)
    scores = torch.from_numpy(s).to(cuda) * valid
    boxes = torch.where(valid[..., None], boxes, 0.0)
    n0 = suppress.launches
    keep, merged = suppress(boxes, boxes, scores, valid, iou_thres=0.6,
                            merge=merge)
    torch.cuda.synchronize()
    assert suppress.launches == n0 + 1
    keep_r, merged_r = suppress_reference(boxes, boxes, scores, valid,
                                          iou_thres=0.6, merge=merge)
    assert torch.equal(keep, keep_r)
    assert 0 < int(keep.sum()) < int(valid.sum())
    m = keep[..., None]
    torch.testing.assert_close(torch.where(m, merged, 0.0),
                               torch.where(m, merged_r, 0.0),
                               rtol=1e-5, atol=1e-4)


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
    # one candidate, an odd width, the largest k, and one past it
    for k in (1, 33, 1024):
        bb, ss, vv = candidates(np.random.default_rng(k), 2, k)
        valid = torch.from_numpy(vv).to(cuda)
        boxes = torch.where(valid[..., None], torch.from_numpy(bb).to(cuda), 0.0)
        scores = torch.from_numpy(ss).to(cuda) * valid
        got = suppress(boxes, boxes, scores, valid, iou_thres=0.45)
        ref = suppress_reference(boxes, boxes, scores, valid, iou_thres=0.45)
        assert torch.equal(got[0], ref[0]), k
        m = got[0][..., None]
        torch.testing.assert_close(torch.where(m, got[1], 0.0),
                                   torch.where(m, ref[1], 0.0),
                                   rtol=1e-5, atol=1e-4)
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
