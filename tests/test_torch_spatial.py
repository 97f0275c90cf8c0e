"""The port's spatial partitioning of inference (``parallel.shard_spatial``
and ``ModelBundle.make_infer(mesh=...)``: the halo rows of each layer, the
global pools' sums over the ranks, the head maps gathered along H) against
the JAX package's whole-image ``make_infer``, on the CPU.

One job of two gloo ranks, started from this file (``python
tests/test_torch_spatial.py --worker R PORT DIR``, no jax there), runs
``make_infer`` dense and sparse on its rows of one f32 image, bs 1, for
two models: yolov3-tiny @256 and ``SPATIAL_CFG`` @128, a narrow cfg with
a row of the halo table in each of its layers (3x3 convs at stride 1 and
2, a grouped conv, SE, the stride-2 maxpool, SPP's 5/9/13 maxpools and
route concat, avgpool + scale_channels, a shortcut, reorg3d, tiny's
k=2/s=1 maxpool, upsample, and two ASFF heads whose bilinear resizes go
both ways). Both ranks' detections are held to JAX's on the whole image
and to the port's one process within rtol 1e-4 / atol 1e-4 (JAX's own
tolerance, ``tests/test_parallel.py::test_spatial_partitioned_infer``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import random_jax_weights
from test_torch_parallel import free_port, spawn, wait

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RANKS = 2
TOL = dict(rtol=1e-4, atol=1e-4)
INFER = dict(conf_thres=0.01, top_k=128, max_det=32)

SPATIAL_CFG = """[net]
width=128
height=128
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
groups=16
filters=16
size=3
stride=1
pad=1
activation=swish

[se]
filters=16

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[maxpool]
stride=1
size=5

[route]
layers=-2

[maxpool]
stride=1
size=9

[route]
layers=-4

[maxpool]
stride=1
size=13

[route]
layers=-1,-3,-5,-6

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[avgpool]

[convolutional]
filters=4
size=1
stride=1
activation=leaky

[convolutional]
filters=16
size=1
stride=1
activation=logistic

[scale_channels]
from=-4

[shortcut]
from=-5
activation=linear

[reorg3d]
stride=2

[maxpool]
size=2
stride=1

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=23
activation=linear

[route]
layers=-2

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,17

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=23
activation=linear

[yolo]
from=21,27
mask=3,4,5
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=2
num=6

[yolo]
from=21,27
mask=0,1,2
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=2
num=6
"""

# (name, cfg file under the job's directory or the repo, image size)
MODELS = (('tiny', os.path.join(ROOT, 'cfg', 'yolov3tiny', 'yolov3-tiny.cfg'),
           256), ('halo', 'spatial.cfg', 128))


def image(size):
    return np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)


def port_dets(root, mesh=None):
    """{'{model}/{dense|sparse}': detections} of the port's ``make_infer``,
    on this rank's rows under ``mesh`` (f32, CPU)."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.parallel import shard_spatial
    out = {}
    for name, cfg, size in MODELS:
        b = trt.load_model(os.path.join(root, cfg), os.path.join(
            root, f'{name}.npz'), device='cpu', dtype=torch.float32)
        x = torch.from_numpy(image(size))
        if mesh is not None:
            x = shard_spatial(mesh, x)
        for sparse in (False, True):
            infer = b.make_infer(sparse=sparse, mesh=mesh, **INFER)
            out[f'{name}/{"sparse" if sparse else "dense"}'] = \
                infer(x).numpy()
    return out


def worker(rank, port, root):
    from yolo_tpu_torch.parallel import init_multihost, make_mesh
    torch.set_num_threads(1)
    dev = init_multihost(f'localhost:{port}', RANKS, rank, device='cpu')
    out = port_dets(root, make_mesh(dev))
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(root, f'rank{rank}.npz'), **out)


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """Write the cfg and the seeded weights, start the job; yields (root,
    wait) where wait() returns both ranks' detections."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    root = str(tmp_path_factory.mktemp('spatial'))
    with open(os.path.join(root, 'spatial.cfg'), 'w') as f:
        f.write(SPATIAL_CFG)
    for name, cfg, _ in MODELS:
        p, s = random_jax_weights(build_ir(os.path.join(root, cfg)), seed=3)
        save_checkpoint(os.path.join(root, f'{name}.npz'), params=p, state=s)
    port = free_port()
    procs = spawn(lambda r: [sys.executable, os.path.abspath(__file__),
                             '--worker', str(r), str(port), root],
                  lambda r: root, n=RANKS)
    done = []

    def wait_all():
        if not done:
            wait(procs)
            done.append([dict(np.load(os.path.join(root, f'rank{r}.npz')))
                         for r in range(RANKS)])
        return done[0]
    try:
        yield root, wait_all
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def jax_dets(root):
    """JAX's ``make_infer`` on the whole images, f32."""
    import jax.numpy as jnp
    from yolo_tpu import runtime as jrt
    out = {}
    for name, cfg, size in MODELS:
        b = jrt.load_model(os.path.join(root, cfg), os.path.join(
            root, f'{name}.npz'), compute_dtype=jnp.float32)
        for sparse in (False, True):
            out[f'{name}/{"sparse" if sparse else "dense"}'] = np.asarray(
                b.make_infer(sparse=sparse, **INFER)(jnp.asarray(image(size))))
    return out


@pytest.fixture(scope='module')
def references(job):
    """JAX's and the port's one-process detections (while the job runs)."""
    return {'jax': jax_dets(job[0]), 'port': port_dets(job[0])}


@pytest.mark.parametrize('key', [f'{m[0]}/{k}' for m in MODELS
                                 for k in ('dense', 'sparse')])
def test_spatial_infer_matches_whole_image(key, job, references):
    """Both ranks return the whole image's detections: equal to each other,
    and to JAX's and the port's one-process ``make_infer`` within 1e-4."""
    res = job[1]()
    np.testing.assert_array_equal(res[0][key], res[1][key])
    assert (references['port'][key][..., 4] > 0).sum() > 0
    for name, want in references.items():
        np.testing.assert_allclose(res[0][key], want[key], **TOL,
                                   err_msg=name)


def test_shard_spatial_splits_rows():
    """``shard_spatial`` over a data axis of 2 hands data index 1 the lower
    rows of every NHWC batch it is given (a tensor contiguous, a numpy
    array as a view), and refuses rows that do not split."""
    from yolo_tpu_torch.parallel import Mesh, shard_spatial
    mesh = Mesh(shape={'data': 2, 'model': 1}, data_index=1,
                data_group=None, device=torch.device('cpu'))
    x = torch.rand(2, 64, 48, 3).permute(0, 2, 1, 3)
    a = np.random.default_rng(0).random((1, 32, 8, 3))
    xs, a_s = shard_spatial(mesh, x, a)
    assert xs.is_contiguous() and torch.equal(xs, x[:, 24:])
    np.testing.assert_array_equal(a_s, a[:, 16:])
    with pytest.raises(ValueError, match='rows'):
        shard_spatial(mesh, torch.rand(1, 63, 64, 3))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--worker']:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
