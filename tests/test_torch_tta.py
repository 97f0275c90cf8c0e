"""The port's test-time augmentation (``models/network.py`` ``scale_img``,
``Darknet.forward_augment``; ``ModelBundle.make_infer(augment=True)``)
against the JAX package's (``scale_img``, ``make_augmented_apply``,
``make_infer(augment=True)``), on the CPU, f32, JAX at 'highest'
precision. Tolerance rtol/atol 1e-4 (summation orders inside the convs;
the bilinear resizes agree to about 1e-6).
"""

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, random_jax_weights

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module', autouse=True)
def _setup():
    import jax
    old = (torch.get_num_threads(), jax.config.jax_default_matmul_precision)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    torch.set_num_threads(old[0])
    jax.config.update('jax_default_matmul_precision', old[1])


@pytest.fixture(scope='module')
def toy_cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp('tta') / 'toy.cfg'
    p.write_text(TOY_CFG)
    return str(p)


@pytest.mark.parametrize('same_shape', [False, True])
@pytest.mark.parametrize('ratio', [0.83, 0.67])
def test_scale_img_matches_jax(ratio, same_shape):
    """A non-square batch, so that both sides' sizes and pads are held."""
    import jax.numpy as jnp
    from yolo_tpu.models.network import scale_img as jscale
    from yolo_tpu_torch.models.network import scale_img
    x = np.random.default_rng(0).uniform(0, 1, (2, 96, 64, 3))
    x = x.astype(np.float32)
    want = np.asarray(jscale(jnp.asarray(x), ratio, same_shape))
    got = scale_img(torch.from_numpy(x), ratio, same_shape)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if not same_shape:
        assert want.shape[1] % 64 == 0 and want.shape[2] % 64 == 0
    assert (want[:, -1, -1] == np.float32(0.447)).all()       # grey pad


@pytest.mark.parametrize('name', ['toy', 'yolov3/yolov3-asff.cfg'])
def test_forward_augment_matches_jax(name, toy_cfg, repo_root):
    """The merged io of the three passes (original, lr-flip at 0.83, 0.67
    scale) against ``make_augmented_apply``, BN unfused."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.network import make_augmented_apply
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.models.network import Darknet
    net = build_ir(toy_cfg if name == 'toy' else f'{repo_root}/cfg/{name}')
    pj, sj = random_jax_weights(net, seed=4,
                                conv_scale=1.0 if name == 'toy' else 0.7)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3))
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(make_augmented_apply(net, compute_dtype=None))(
        pj, sj, jnp.asarray(x)))
    pt, st = from_jax(net, pj, sj)
    with torch.no_grad():
        got = Darknet(net, pt, st).eval().forward_augment(torch.from_numpy(x))
    n_rows = sum(l.na * (64 // l.yolo_stride) ** 2
                 for l in net.layers if l.kind == 'yolo')
    assert got.shape == want.shape == (2, 3 * n_rows, net.nc + 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _bundles(toy_cfg, tmp_path):
    """The JAX and port bundles of one seeded .npz, f32, BN folded."""
    from yolo_tpu import runtime as jrt
    from yolo_tpu.ir import build_ir
    from yolo_tpu.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch import runtime as trt
    params, state = random_jax_weights(build_ir(toy_cfg), seed=21)
    npz = str(tmp_path / 'toy.npz')
    save_checkpoint(npz, params=params, state=state)
    return (jrt.load_model(toy_cfg, npz, compute_dtype=None).fuse(),
            trt.load_model(toy_cfg, npz, device='cpu',
                           dtype=torch.float32).fuse(), npz)


def test_make_infer_augment_matches_jax(toy_cfg, tmp_path):
    """``make_infer(augment=True)``: the detections of the merged io after
    the dense NMS equal JAX's (rtol/atol 1e-4), and differ from the
    single pass."""
    from yolo_tpu import runtime as jrt
    from yolo_tpu_torch import runtime as trt
    jb, tb, _ = _bundles(toy_cfg, tmp_path)
    kw = dict(conf_thres=0.05, iou_thres=0.5, top_k=128, max_det=64)
    x = images(6, 2, 64)
    want = np.asarray(jb.make_infer(augment=True, **kw)(jrt.preprocess(x)))
    xt = trt.preprocess(x, device='cpu')
    got = tb.make_infer(augment=True, **kw)(xt)
    assert got.shape == want.shape == (2, 64, 6)
    assert (want[..., 4] > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not torch.equal(got, tb.make_infer(**kw)(xt))


def test_quantized_make_infer_augment_warns_single_pass(toy_cfg, tmp_path,
                                                        capsys):
    """A quantized bundle prints the JAX package's warning and runs its
    single pass (the int8 engine and the sim alike)."""
    from yolo_tpu_torch import runtime as trt
    npz = _bundles(toy_cfg, tmp_path)[2]
    b = trt.load_model(toy_cfg, npz, device='cpu', quantized=1, steps=100)
    x = trt.preprocess(images(7, 2, 64), device='cpu')
    b.apply(x, train=True)
    for engine in (None, False):
        capsys.readouterr()
        got = b.make_infer(augment=True, conf_thres=0.01, engine=engine)(x)
        assert ('WARNING: --augment (TTA) is not supported with quantized '
                'inference; running single-pass') in capsys.readouterr().out
        want = b.make_infer(conf_thres=0.01, engine=engine)(x)
        assert torch.equal(got, want) and int((want[..., 4] > 0).sum()) > 0
