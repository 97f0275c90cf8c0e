"""yolo_tpu_torch.ops and the head decode against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
PyTorch counterpart. Tolerance rtol/atol 1e-5 in f32, 1e-4 for convs (a
different summation order over up to 9*C products); JAX convs run at
'highest' precision, since its default f32 CPU conv is off by ~7e-3.
NHWC arrays become NCHW tensors with ``permute(0, 3, 1, 2)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.models import yolo_head as jhead
from yolo_tpu.ops import activations as jact
from yolo_tpu.ops import boxes as jboxes
from yolo_tpu.ops import conv as jconv
from yolo_tpu_torch.models import yolo_head as thead
from yolo_tpu_torch.ops import activations as tact
from yolo_tpu_torch.ops import boxes as tboxes
from yolo_tpu_torch.ops import conv as tconv


@pytest.fixture(scope='module', autouse=True)
def _setup():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    old_prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    jax.config.update('jax_default_matmul_precision', old_prec)
    torch.set_num_threads(old_threads)


def _nchw(a):
    """NHWC numpy -> NCHW tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize('name', sorted(jact._BY_NAME))
@pytest.mark.parametrize('maxabs', [False, True])
def test_activations(name, maxabs):
    x = np.random.default_rng(0).normal(0, 4, (64,)).astype(np.float32)
    ref = np.asarray(jact.get(name, maxabs)(jnp.asarray(x)))
    got = tact.get(name, maxabs)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_activation_unknown_raises():
    with pytest.raises(ValueError):
        tact.get('gelu')


def _rand_boxes(rng, n):
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(1, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize('fn', ['xywh2xyxy', 'xyxy2xywh'])
def test_box_transforms(fn):
    x = _rand_boxes(np.random.default_rng(1), 50)
    ref = np.asarray(getattr(jboxes, fn)(jnp.asarray(x)))
    got = getattr(tboxes, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_box_iou_matrix_bit_exact():
    rng = np.random.default_rng(2)
    a, b = _rand_boxes(rng, 40), _rand_boxes(rng, 30)
    b[:5] = a[:5]                                      # self-IoU rows
    ref = np.asarray(jboxes.box_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.box_iou_matrix(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), ref)
    # batched form
    got2 = tboxes.box_iou_matrix(torch.from_numpy(np.stack([a, a])),
                                 torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(got2.numpy(), np.stack([ref, ref]))


def test_clip_and_scale_coords():
    rng = np.random.default_rng(3)
    c = rng.uniform(-50, 700, (20, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tboxes.clip_coords(torch.from_numpy(c), (480, 640)).numpy(),
        np.asarray(jboxes.clip_coords(jnp.asarray(c), (480, 640))),
        rtol=1e-6)
    for ratio_pad in (None, ((0.5, 0.5), (10.0, 20.0))):
        ref = np.asarray(jboxes.scale_coords((640, 640), c, (480, 640),
                                             ratio_pad))
        got = tboxes.scale_coords((640, 640), c, (480, 640), ratio_pad)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('k,stride,pad,groups', [
    (3, 1, 1, 1), (3, 2, 1, 1), (1, 1, 0, 1), (3, 1, 1, 2), (3, (1, 2), 1, 1),
])
def test_conv2d(k, stride, pad, groups):
    rng = np.random.default_rng(4)
    cin, cout = 8, 6
    x = rng.normal(0, 1, (2, 12, 10, cin)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, cin // groups, cout)).astype(np.float32)
    ref = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                  padding=pad, groups=groups,
                                  compute_dtype=None))
    got = tconv.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1)),
                       stride=stride, padding=pad, groups=groups)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-4, atol=1e-4)


def test_batch_norm_infer_and_fuse():
    rng = np.random.default_rng(5)
    c = 6
    x = rng.normal(0, 1, (2, 5, 5, 4)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, 4, c)).astype(np.float32)
    gamma, beta = rng.uniform(.6, 1.4, c), rng.normal(0, .1, c)
    mean, var = rng.normal(0, .3, c), rng.uniform(.5, 2, c)
    bn = [a.astype(np.float32) for a in (gamma, beta, mean, var)]
    y = rng.normal(0, 1, (2, 5, 5, c)).astype(np.float32)
    ref = np.asarray(jconv.batch_norm_infer(jnp.asarray(y),
                                            *map(jnp.asarray, bn)))
    got = tconv.batch_norm_infer(_nchw(y), *map(torch.from_numpy, bn))
    np.testing.assert_allclose(_nhwc(got), ref, rtol=1e-5, atol=1e-5)

    wj, bj = jconv.fuse_conv_bn(jnp.asarray(w), None, *map(jnp.asarray, bn))
    wt, bt = tconv.fuse_conv_bn(torch.from_numpy(w.transpose(3, 2, 0, 1)), None,
                                *map(torch.from_numpy, bn))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj).transpose(3, 2, 0, 1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-5, atol=1e-6)
    # the folded conv equals conv + BN
    ref2 = np.asarray(jconv.batch_norm_infer(
        jconv.conv2d(jnp.asarray(x), jnp.asarray(w), padding=1,
                     compute_dtype=None), *map(jnp.asarray, bn)))
    got2 = tconv.conv2d(_nchw(x), wt, padding=1, bias=bt)
    np.testing.assert_allclose(_nhwc(got2), ref2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('size,stride', [(2, 1), (2, 2), (3, 1), (5, 1),
                                         (9, 1), (13, 1), (3, 2)])
def test_max_pool(size, stride):
    # negative inputs: the k=2/s=1 case pads with zeros, the rest with -inf
    x = np.random.default_rng(6).normal(-1, 1, (2, 13, 13, 3)).astype(np.float32)
    ref = np.asarray(jconv.max_pool(jnp.asarray(x), size, stride))
    got = tconv.max_pool(_nchw(x), size, stride)
    assert got.shape == (2, 3) + ref.shape[1:3]
    np.testing.assert_array_equal(_nhwc(got), ref)


@pytest.mark.parametrize('scale', [2, 3])
def test_upsample_nearest(scale):
    x = np.random.default_rng(7).normal(0, 1, (2, 3, 5, 4)).astype(np.float32)
    ref = np.asarray(jconv.upsample_nearest(jnp.asarray(x), scale))
    got = tconv.upsample_nearest(_nchw(x), scale)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), ref)


@pytest.mark.parametrize('stride', [2, 4])
def test_space_to_depth_channel_order(stride):
    x = np.random.default_rng(8).normal(0, 1, (2, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jconv.space_to_depth(jnp.asarray(x), stride))
    got = tconv.space_to_depth(_nchw(x), stride)
    np.testing.assert_array_equal(_nhwc(got), ref)
    # the NHWC order (sy*s + sx)*C + c is not pixel_unshuffle's
    if stride == 2:
        pu = torch.nn.functional.pixel_unshuffle(_nchw(x).contiguous(), stride)
        assert not np.array_equal(_nhwc(pu), ref)


def test_reshape_pred_and_decode():
    rng = np.random.default_rng(9)
    bs, ny, nx, na, no = 2, 4, 5, 3, 7
    x = rng.normal(0, 1, (bs, ny, nx, na * no)).astype(np.float32)
    anchors = np.array([[10, 13], [16, 30], [33, 23]], np.float32)
    pj = jhead.reshape_pred(jnp.asarray(x), na, no)
    pt = thead.reshape_pred(torch.from_numpy(x), na, no)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(thead.decode_yolo(pt, anchors, 32).numpy(),
                               np.asarray(jhead.decode_yolo(pj, anchors, 32)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_decode_yolo_nhwc(dtype):
    rng = np.random.default_rng(10)
    bs, ny, nx, na, no = 2, 5, 7, 3, 9
    x = rng.normal(0, 2, (bs, ny, nx, na * no)).astype(np.float32)
    anchors = np.array([[10, 13], [16, 30], [33, 23]], np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(jhead.decode_yolo_nhwc(xj, anchors, 16, no))
    got = thead.decode_yolo_nhwc(xt, anchors, 16, no)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
