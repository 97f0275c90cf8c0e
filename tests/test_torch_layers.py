"""The port's SE block, MixConv and grouped int8 conv against the JAX
package, on the CPU.

``se_block`` and ``mixconv2d`` are held to JAX's (f32, 'highest' matmul
precision) within rtol/atol 1e-5; ``mixconv_channel_split`` exactly. The
grouped int8 conv (``ops/conv_int8.grouped_conv_int8``, the engine's path
for the depthwise and grouped convs K2 does not take) is held bit for bit
to JAX's XLA s8 conv with s32 sums (``lax.conv_general_dilated(...,
feature_group_count, preferred_element_type=int32)``) under the JAX
engine's epilogue.

The test marked ``gpu`` holds the grouped int8 conv on the card to its CPU
result; it needs no jax:
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_layers.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def jax_highest():
    import jax
    old = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield jax
    jax.config.update('jax_default_matmul_precision', old)


def test_se_block_matches_jax(jax_highest):
    import jax.numpy as jnp
    from yolo_tpu.ops.conv import se_block as jse
    from yolo_tpu_torch.ops import conv as C
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 7, 5, 24)).astype(np.float32)
    fc1 = rng.normal(0, 3.0, (6, 24)).astype(np.float32)
    fc2 = rng.normal(0, 3.0, (24, 6)).astype(np.float32)
    want = np.asarray(jse(jnp.asarray(x), jnp.asarray(fc1), jnp.asarray(fc2)))
    t = [torch.from_numpy(a) for a in (x, fc1, fc2)]
    np.testing.assert_allclose(C.se_block_nhwc(*t).numpy(), want, **TOL)
    nchw = C.se_block(t[0].permute(0, 3, 1, 2), t[1], t[2])
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), want, **TOL)
    # the gate spans its range: channels off, in between, and on
    gate = want[:, 0, 0] / x[:, 0, 0]
    assert gate.min() < 0.01 and gate.max() > 0.99
    assert ((gate > 0.1) & (gate < 0.9)).any()


def test_mixconv_matches_jax(jax_highest):
    import jax.numpy as jnp
    from yolo_tpu.ops.conv import mixconv2d as jmix
    from yolo_tpu.ops.conv import mixconv_channel_split as jsplit
    from yolo_tpu_torch.ops import conv as C
    for out_ch in (1, 7, 16, 33, 128):
        for ks in ((3, 5, 7), (3, 5), (1, 3, 5, 7, 9)):
            for method in ('equal_ch', 'equal_params'):
                got = C.mixconv_channel_split(out_ch, ks, method)
                assert got == jsplit(out_ch, ks, method), (out_ch, ks, method)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 11, 9, 8)).astype(np.float32)
    split = C.mixconv_channel_split(12, (3, 5, 7))
    ws = [rng.normal(0, 0.2, (k, k, 8, c)).astype(np.float32)
          for k, c in zip((3, 5, 7), split)]
    for stride in (1, 2):
        want = np.asarray(jmix(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                               stride=stride, compute_dtype=None))
        got = C.mixconv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                          [torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
                           for w in ws], stride=stride)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   **TOL)


# (k, stride, groups): 'dw' is a depthwise conv (groups = Cin = Cout)
GROUPED = [(k, s, g) for k in (3, 5) for s in (1, 2) for g in ('dw', 2)]


def _grouped_case(k, g, seed=0):
    rng = np.random.RandomState(seed)
    cin = 24
    groups = cin if g == 'dw' else g
    cout = cin if g == 'dw' else 16
    x8 = rng.randint(-128, 128, (2, 13, 11, cin)).astype(np.int8)
    w8 = rng.randint(-128, 128, (k, k, cin // groups, cout)).astype(np.int8)
    bias = rng.randn(cout).astype(np.float32)
    return x8, w8, bias, groups


@pytest.mark.parametrize('k,stride,g', GROUPED,
                         ids=[f'{k}x{k}s{s}_{g}' for k, s, g in GROUPED])
def test_grouped_int8_conv_matches_jax_lax(k, stride, g):
    """The s32 sums equal to JAX's s32 lax conv, and the int8 out
    bit-equal under the JAX engine's epilogue (h_swish, a pow-2 out
    scale); the weights span the full int8 range."""
    import jax.numpy as jnp
    from jax import lax
    from yolo_tpu.compress.quant import round_half_away as jround
    from yolo_tpu.ops.activations import get as jact
    from yolo_tpu_torch.ops.conv_int8 import (grouped_conv_int8,
                                              grouped_conv_s32)
    x8, w8, bias, groups = _grouped_case(k, g)
    pad = k // 2
    acc = lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8), (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    # a pow-2 scale that puts the sums' std at about 40 quanta
    scale = 2.0 ** round(np.log2(2.5 / (74.0 ** 2 * np.sqrt(
        k * k * w8.shape[2]))))
    sa = 2.0 ** -4
    y = acc.astype(jnp.float32) * scale + jnp.asarray(bias)
    y = jact('h_swish')(y)
    want = np.asarray(jnp.clip(jround(y * (1.0 / sa)), -128, 127)
                      .astype(jnp.int8))
    x8t = torch.from_numpy(x8)
    w_ohwi = torch.from_numpy(np.ascontiguousarray(w8.transpose(3, 0, 1, 2)))
    sums = grouped_conv_s32(x8t, w_ohwi, stride=stride, pad=pad,
                            groups=groups)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), np.asarray(acc))
    n0 = grouped_conv_int8.calls
    got = grouped_conv_int8(x8t, w_ohwi, torch.from_numpy(bias), scale, sa,
                            stride=stride, pad=pad, groups=groups,
                            act='h_swish')
    assert grouped_conv_int8.calls == n0 + 1
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 60          # the grid is well used


@pytest.mark.gpu
@pytest.mark.parametrize('k,stride,g', GROUPED,
                         ids=[f'{k}x{k}s{s}_{g}' for k, s, g in GROUPED])
def test_grouped_int8_conv_on_card_matches_cpu(k, stride, g):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from yolo_tpu_torch.ops.conv_int8 import grouped_conv_int8
    x8, w8, bias, groups = _grouped_case(k, g, seed=1)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (x8, w8.transpose(3, 0, 1, 2), bias)]
    kw = dict(stride=stride, pad=k // 2, groups=groups, act='h_swish')
    want = grouped_conv_int8(*args, 2.0 ** -11, 2.0 ** -4, **kw)
    got = grouped_conv_int8(*[a.cuda() for a in args], 2.0 ** -11,
                            2.0 ** -4, **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_mobilenet_forward_on_card_matches_cpu():
    """yolov3-mobilenet (depthwise convs, SE blocks) at 416 px, f32 with
    TF32 off: the card's fused heads within rtol/atol 1e-3 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from yolo_tpu_torch import runtime as trt
    cfg = os.path.join(ROOT, 'cfg', 'yolov3-mobilenet',
                       'yolov3-mobilenet-visdrone.cfg')
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.rand(2, 416, 416, 3, generator=torch.Generator().manual_seed(0))
        heads = {}
        for dev in ('cpu', 'cuda'):
            b = trt.load_model(cfg, device=dev, dtype=torch.float32,
                               conv_scale=1.0,
                               generator=torch.Generator().manual_seed(0))
            with torch.no_grad():
                heads[dev] = b.fuse().model().forward_heads(x.to(dev))[0]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    for a, c in zip(heads['cuda'], heads['cpu']):
        assert float(c.abs().max()) > 1.0
        torch.testing.assert_close(a.cpu(), c, rtol=1e-3, atol=1e-3)
