"""The port's float forward on the cfgs with depthwise convs, SE, global
avgpool + scale_channels, reorg3d and ASFF heads, against the JAX package.

Each cfg runs at 64 px (the smallest multiple of 32 at which every one of
them builds, its reorg3d strides and ASFF resizes included), with weights
from ``random_jax_weights`` (numpy, seeded) carried across by
``convert.from_jax``. The eval io (f32, BN unfused) and the fused
``forward_heads`` heads and slim objectness maps are held to rtol/atol
1e-4 against JAX at 'highest' precision: both sides compute in f32, with
different summation orders inside the convs and the SE means.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import random_jax_weights
from yolo_tpu.ir import build_ir
from yolo_tpu.models.network import fuse_params as jfuse
from yolo_tpu.models.network import make_apply
from yolo_tpu_torch.convert import from_jax
from yolo_tpu_torch.models.network import (Darknet, check_supported,
                                           fuse_params)

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 64

# the cfgs whose layer kinds the port's first slices lacked
NEW_CFGS = ([f'yolov3-mobilenet/yolov3-mobilenet-{d}.cfg'
             for d in ('UAV', 'coco', 'hand', 'screw', 'visdrone')]
            + [f'yolov3tiny-mobilenet-small/yolov3tiny-mobilenet-small-{d}.cfg'
               for d in ('UAV', 'coco', 'screw', 'visdrone')]
            + ['yolov3-ghostnet/yolov3-ghost-coco.cfg',
               'yolov3tiny-efficientnetB0/yolov3tiny-efficientnetB0.cfg',
               'yolov3/yolov3-spp-pan-scale.cfg', 'yolov3/yolov3-asff.cfg'])


@pytest.fixture(scope='module', autouse=True)
def _setup():
    old_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    old_prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    yield
    jax.config.update('jax_default_matmul_precision', old_prec)
    torch.set_num_threads(old_threads)


def test_every_cfg_is_supported(repo_root):
    """All 43 cfgs under cfg/ build in the port, the 13 above among them."""
    from yolo_tpu_torch.ir import build_ir as tbuild
    cfgs = sorted(glob.glob(f'{repo_root}/cfg/**/*.cfg', recursive=True))
    assert len(cfgs) == 43
    assert {f'{repo_root}/cfg/{c}' for c in NEW_CFGS} <= set(cfgs)
    for path in cfgs:
        check_supported(tbuild(path))


@pytest.mark.parametrize('name', NEW_CFGS,
                         ids=[n.split('/')[-1][:-4] for n in NEW_CFGS])
def test_new_cfg_forward_matches_jax(name, repo_root):
    net = build_ir(f'{repo_root}/cfg/{name}')
    pj, sj = random_jax_weights(net, seed=1, conv_scale=0.7)
    x = np.random.default_rng(2).uniform(0, 1, (2, SIZE, SIZE, 3))
    x = x.astype(np.float32)
    io_j, _, _ = jax.jit(make_apply(net, compute_dtype=None))(
        pj, sj, jnp.asarray(x))
    heads_j, objs_j = jax.jit(make_apply(net, compute_dtype=None, fused=True,
                                         heads_only=True))(
        jfuse(net, pj, sj), {}, jnp.asarray(x))
    pt, st = from_jax(net, pj, sj)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        io_t = Darknet(net, pt, st).eval()(xt)
        heads_t, objs_t = Darknet(net, fuse_params(net, pt, st),
                                  fused=True).eval().forward_heads(xt)
    assert io_t.shape == io_j.shape and io_t.dtype == torch.float32
    np.testing.assert_allclose(io_t.numpy(), np.asarray(io_j), **TOL)
    assert len(heads_t) == len(heads_j) == len(objs_t) == len(objs_j)
    asff = 'asff' in name
    for hj, ht, oj, ot in zip(heads_j, heads_t, objs_j, objs_t):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        assert (oj is None) == (ot is None) == asff
        if ot is not None:
            np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
