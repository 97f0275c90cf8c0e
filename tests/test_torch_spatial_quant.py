"""Spatially split serving of quantized models and of test-time augmentation
(``ModelBundle.make_infer(mesh=...)`` on ``parallel.shard_spatial``'s rows:
the fake-quant sim, the int8 engine with its int8 halo rows, K2 on
stride-aligned blocks and the int8 heads gathered into the sparse NMS, and
TTA's three passes) against the JAX package's whole-image ``make_infer``,
on the CPU.

One job of two gloo ranks, started from this file (``python
tests/test_torch_spatial_quant.py --worker R PORT DIR``, no jax there),
serves its rows of each image:

- ``LEAKY_CFG`` @64 (bs 2), with a JAX-calibrated google qstate and a
  TPSQ warmup, on images / 256, where the float stem conv is exact in f32
  and every int8 tensor compares bit for bit: the engine's gathered int8
  heads and obj maps bit-equal to JAX's ``backend='xla'`` engine on the
  whole image, the engine's and the sim's detections within 1e-4 of JAX's;
- ``SPATIAL_Q_CFG`` @128 (bs 2), ``test_torch_spatial.SPATIAL_CFG`` with
  plain heads for its ASFF ones (the quantized paths refuse ASFF): 3x3
  stride-2 convs, SPP's 5/9/13 and tiny's k=2/s=1 maxpools on int8 edges, a
  grouped conv, SE, avgpool with scale_channels, a shortcut, reorg3d, two
  requantized concats and an upsample. The SE and avgpool means over the
  ranks are exact (their inputs are grid values, whose sums f32 holds in
  any order), but the SE fcs and the float-edge convs after them are
  float sums in both frameworks: its int8 heads are held to JAX's engine
  as one process's are (``test_torch_mobilenet_int8.py``: at most 1% of
  the values apart, by at most 2 LSB) and to the port's one process bit
  for bit;
- float TTA on yolov3-tiny @256 and on ``SPATIAL_CFG`` (with its ASFF
  heads) @128, within 1e-4 of JAX's ``make_infer(augment=True)``;
- a quantized bundle with ``augment=True``: the warning, then the single
  spatial pass's detections.

Two one-process tests hold the row rules that the float halo rules do not
cover: K2's stride-aligned block and crop (``ops/conv_int8.k2_rows``)
through K2's plain twin, and ``max_pool_rows`` on an int8 edge, each
against the whole image, with the neighbours' rows cut from the whole
tensor in place of the exchange.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import images, random_jax_weights
from test_torch_int8 import LEAKY_CFG
from test_torch_parallel import free_port, spawn, wait
from test_torch_spatial import SPATIAL_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RANKS = 2
TOL = dict(rtol=1e-4, atol=1e-4)
INFER = dict(conf_thres=0.05, iou_thres=0.5, top_k=64, max_det=32)
TTA_INFER = dict(conf_thres=0.01, top_k=128, max_det=32)

_ASFF_HEADS = SPATIAL_CFG[SPATIAL_CFG.index('[convolutional]\nsize=1\n'
                                            'stride=1\npad=1\nfilters=23'):]
SPATIAL_Q_CFG = SPATIAL_CFG.replace(_ASFF_HEADS, """[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask=3,4,5
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=2
num=6

[route]
layers=-3

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
filters=21
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58, 81,82, 135,169, 344,319
classes=2
num=6
""")

# (name, cfg file, --quantized, image size)
QUANT = (('leaky', 'leaky.cfg', 1, 64), ('halo_q', 'halo_q.cfg', 1, 128),
         ('tpsq', 'leaky.cfg', 2, 64))
# (name, cfg file under the job's directory or the repo, image size)
TTA = (('tiny', os.path.join(ROOT, 'cfg', 'yolov3tiny', 'yolov3-tiny.cfg'),
        256), ('halo', 'spatial.cfg', 128))


def quant_image(size):
    """The calibration batch, served as well: bs 2, images / 256."""
    return images(2, 2, size).astype(np.float32) / 256.0


def tta_image(size):
    return np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)


def port_outputs(root, mesh=None):
    """The port's outputs on this rank's rows under ``mesh`` (f32, CPU):
    for each quantized model the engine's int8 heads and obj maps
    (``{name}/head{i}``, ``{name}/obj{i}``), its decoded io (``heads_only``
    off: the heads gathered before the decode) and the engine's and
    (google) the sim's detections; the float TTA detections; the quantized bundle's
    ``augment=True`` detections and whether it warned."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.models.int8_engine import make_int8_apply, prepare_int8
    from yolo_tpu_torch.parallel import shard_spatial
    sp = None if mesh is None else mesh.data_group
    cut = (lambda x: x) if mesh is None else (lambda x: shard_spatial(mesh, x))
    out = {}
    for name, cfg, q, size in QUANT:
        b = trt.load_model(os.path.join(root, cfg), os.path.join(
            root, f'{name}.npz'), device='cpu', quantized=q, steps=100)
        x = cut(torch.from_numpy(quant_image(size)))
        plan = prepare_int8(b.net, b.params, b.state, b.qstate, b.qcfg)
        eng = make_int8_apply(b.net, plan, heads_only=True, spatial=sp)
        heads, objs = eng(plan.arrays, x)
        for i, (h, o) in enumerate(zip(heads, objs)):
            out[f'{name}/head{i}'] = h.numpy()
            out[f'{name}/obj{i}'] = o.numpy()
        out[f'{name}/io'] = make_int8_apply(b.net, plan, spatial=sp)(
            plan.arrays, x)[0].numpy()
        out[f'{name}/engine'] = b.make_infer(engine=True, mesh=mesh,
                                             **INFER)(x).numpy()
        if q == 1:
            out[f'{name}/sim'] = b.make_infer(engine=False, mesh=mesh,
                                              **INFER)(x).numpy()
        if name == 'leaky':
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                infer = b.make_infer(augment=True, mesh=mesh, **INFER)
            out['leaky/augment'] = infer(x).numpy()
            out['leaky/warned'] = np.array('WARNING: --augment' in
                                           said.getvalue())
    for name, cfg, size in TTA:
        b = trt.load_model(os.path.join(root, cfg), os.path.join(
            root, f'{name}.npz'), device='cpu', dtype=torch.float32)
        x = cut(torch.from_numpy(tta_image(size)))
        out[f'{name}/tta'] = b.make_infer(augment=True, mesh=mesh,
                                          **TTA_INFER)(x).numpy()
    return out


def worker(rank, port, root):
    from yolo_tpu_torch.parallel import init_multihost, make_mesh
    torch.set_num_threads(1)
    dev = init_multihost(f'localhost:{port}', RANKS, rank, device='cpu')
    out = port_outputs(root, make_mesh(dev))
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(root, f'rank{rank}.npz'), **out)


def _google_calibrated(cfg_path, size):
    """JAX params (numpy seed 0), then state and qstate after 3 jitted
    google calibration steps on ``quant_image(size)`` (the recipe of
    ``tests/test_torch_int8.py``, there eager)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    net = build_ir(cfg_path)
    params, state = random_jax_weights(net, seed=0, conv_scale=1.0)
    cfg = JQ.QuantConfig(scheme='google', steps=100)
    qstate = JQ.init_quant_state(net, cfg)[0]
    apply_q = jax.jit(JQ.make_quant_apply(net, cfg, compute_dtype=None),
                      static_argnums=4)
    x = jnp.asarray(quant_image(size))
    for _ in range(3):
        _, state, qstate = apply_q(params, state, qstate, x, True)
    return jax.tree.map(np.asarray, jax.device_get((params, state, qstate)))


def _tpsq_warmed(cfg_path):
    """JAX params (with TPSQ's scale params from its warmup), state and
    qstate of ``cfg_path`` on ``quant_image(64)``, as
    ``tests/test_torch_quant_schemes.py`` makes them."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    net = build_ir(cfg_path)
    pj, sj = random_jax_weights(net, seed=0, conv_scale=1.0)
    cfg = JQ.QuantConfig(scheme='tpsq', steps=100)
    qj, extra = JQ.init_quant_state(net, cfg)
    for k, v in extra.items():
        pj[k] = {**pj[k], **{f: np.asarray(a) for f, a in v.items()}}
    pj = JQ.tpsq_warmup(net, cfg, pj, sj, qj, jnp.asarray(quant_image(64)))
    return jax.tree.map(np.asarray, jax.device_get((pj, sj, qj)))


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """Write the cfgs, the JAX-calibrated quantized checkpoints and the
    float weights, start the job; yields (root, wait) where wait() returns
    both ranks' outputs."""
    import jax
    from yolo_tpu.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch.ir import build_ir
    root = str(tmp_path_factory.mktemp('spatial_quant'))
    for fname, text in (('leaky.cfg', LEAKY_CFG), ('halo_q.cfg', SPATIAL_Q_CFG),
                        ('spatial.cfg', SPATIAL_CFG)):
        with open(os.path.join(root, fname), 'w') as f:
            f.write(text)
    old = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    try:
        for name, cfg, q, size in QUANT:
            path = os.path.join(root, cfg)
            params, state, qstate = (_google_calibrated(path, size) if q == 1
                                     else _tpsq_warmed(path))
            save_checkpoint(os.path.join(root, f'{name}.npz'),
                            params=params, state=state, qstate=qstate)
    finally:
        jax.config.update('jax_default_matmul_precision', old)
    for name, cfg, _ in TTA:
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


def jax_outputs(root):
    """JAX's outputs on the whole images, keyed as ``port_outputs``'s: the
    ``backend='xla'`` engine's int8 heads, obj maps and io (jitted), and
    ``make_infer``'s detections, f32."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu import runtime as jrt
    from yolo_tpu.models.int8_engine import make_int8_apply, prepare_int8
    out = {}
    for name, cfg, q, size in QUANT:
        b = jrt.load_model(os.path.join(root, cfg), os.path.join(
            root, f'{name}.npz'), quantized=q, steps=100,
            compute_dtype=jnp.float32)
        x = jnp.asarray(quant_image(size))
        plan = prepare_int8(b.net, b.params, b.state, b.qstate, b.qcfg)
        eng = make_int8_apply(b.net, plan, backend='xla', heads_only=True)
        heads, objs = jax.jit(eng)(plan.arrays, x)
        for i, (h, o) in enumerate(zip(heads, objs)):
            out[f'{name}/head{i}'] = np.asarray(h)
            out[f'{name}/obj{i}'] = np.asarray(o)
        out[f'{name}/io'] = np.asarray(jax.jit(make_int8_apply(
            b.net, plan, backend='xla'))(plan.arrays, x)[0])
        out[f'{name}/engine'] = np.asarray(b.make_infer(engine=True,
                                                        **INFER)(x))
        if q == 1:
            out[f'{name}/sim'] = np.asarray(b.make_infer(engine=False,
                                                         **INFER)(x))
    for name, cfg, size in TTA:
        b = jrt.load_model(os.path.join(root, cfg), os.path.join(
            root, f'{name}.npz'), compute_dtype=jnp.float32)
        out[f'{name}/tta'] = np.asarray(b.make_infer(augment=True,
                                                     **TTA_INFER)(
            jnp.asarray(tta_image(size))))
    return out


@pytest.fixture(scope='module')
def references(job):
    """JAX's and the port's one-process outputs (while the job runs)."""
    return {'jax': jax_outputs(job[0]), 'port': port_outputs(job[0])}


@pytest.mark.parametrize('name', [q[0] for q in QUANT])
def test_split_engine_int8_heads(name, job, references):
    """The int8 engine on each rank's rows, its int8 heads and obj maps
    gathered whole: equal on both ranks, bit-equal to the port's one
    process, and to JAX's ``backend='xla'`` engine on the whole image:
    bit for bit where every sum is exact (``leaky``, ``tpsq``), to one
    process's standard where SE's fcs and the float-edge convs after it
    sum floats in each framework's order (``halo_q``)."""
    res = job[1]()
    port, jx = references['port'], references['jax']
    keys = [k for k in jx if k.startswith(f'{name}/head')
            or k.startswith(f'{name}/obj')]
    assert len(keys) == 4
    for k in keys:
        got = res[0][k]
        np.testing.assert_array_equal(res[1][k], got, err_msg=k)
        np.testing.assert_array_equal(got, port[k], err_msg=k)
        assert got.shape == jx[k].shape and got.dtype == jx[k].dtype, k
        if name != 'halo_q':
            np.testing.assert_array_equal(got, jx[k], err_msg=k)
        elif '/head' in k:
            d = np.abs(got.astype(np.int32) - jx[k].astype(np.int32))
            assert (d > 0).mean() <= 0.01 and d.max() <= 2, (k, d.max())
            assert np.abs(got).max() > 30, k             # not a dead head


@pytest.mark.parametrize('key', ['leaky/engine', 'leaky/sim',
                                 'halo_q/engine', 'halo_q/sim', 'tpsq/engine',
                                 'tiny/tta', 'halo/tta', 'leaky/io',
                                 'halo_q/io', 'tpsq/io'])
def test_split_detections_match_whole_image(key, job, references):
    """Both ranks return the whole image's detections (and the engine's
    decoded io): equal to each other, and to JAX's and the port's
    one-process outputs within 1e-4 (JAX's own tolerance for spatial
    partitioning,
    ``tests/test_parallel.py::test_spatial_partitioned_infer``)."""
    res = job[1]()
    np.testing.assert_array_equal(res[0][key], res[1][key])
    assert (references['port'][key][..., 4] > 0).sum() > 0
    for name, want in references.items():
        np.testing.assert_allclose(res[0][key], want[key], **TOL,
                                   err_msg=name)


def test_split_quantized_augment_is_one_spatial_pass(job):
    """A quantized bundle with ``augment=True`` on a mesh prints the JAX
    package's warning and serves the single spatial pass: the engine's
    detections, bit for bit, on both ranks."""
    res = job[1]()
    for r in res:
        assert bool(r['leaky/warned'])
        np.testing.assert_array_equal(r['leaky/augment'], r['leaky/engine'])


# ---------------------------------------- the row rules, in one process

class _Rows:
    """Rank ``r`` of ``n`` in one process: its neighbours' edge rows are cut
    from ``whole`` (NHWC), in the dtype and with the ``fill`` that
    ``parallel.collectives.halo_rows`` would hand it."""

    def __init__(self, whole, n, r):
        self.whole, self.n, self.r = whole, n, r

    def halo(self, x, above, below, fill):
        h = x.shape[1]
        r0 = self.r * h
        assert torch.equal(x, self.whole[:, r0:r0 + h].to(x.dtype))
        if max(above, below) > h:
            raise ValueError('a halo is more than the rows of a rank')

        def edge(k):
            return x.new_full((x.shape[0], k, *x.shape[2:]), fill)
        over = (self.whole[:, r0 - above:r0].to(x.dtype) if self.r > 0
                else edge(above))
        under = (self.whole[:, r0 + h:r0 + h + below].to(x.dtype)
                 if self.r < self.n - 1 else edge(below))
        return over, under


@pytest.fixture
def rows_in_one_process(monkeypatch):
    """Route ``ops/conv``'s halo exchange to the ``_Rows`` passed as its
    group."""
    from yolo_tpu_torch.ops import conv as C
    monkeypatch.setattr(C, 'halo_rows', lambda x, above, below, group,
                        fill=0.0: group.halo(x, above, below, fill))


@pytest.mark.parametrize('n', [2, 4])
@pytest.mark.parametrize('k,stride', [(3, 1), (3, 2), (1, 1)])
def test_k2_rows_stride_aligned_block(k, stride, n, rows_in_one_process):
    """K2's plain twin on each rank's stride-aligned block (``k2_rows``:
    3x3 s1 one row over and under, 3x3 s2 two over and none under, output
    rows 1 .. rows / stride kept), joined in rank order, equals the twin on
    the whole image bit for bit: the block under the float rule (one row
    over for s2) would put darknet's rows off K2's stride-2 grid."""
    from yolo_tpu_torch.ops.conv_int8 import (fused_conv_int8_reference,
                                              k2_rows)
    g = torch.Generator().manual_seed(k * 10 + stride)
    x8 = torch.randint(-128, 128, (2, 16, 13, 24), dtype=torch.int8,
                       generator=g)
    w8 = torch.randint(-40, 41, (32, k, k, 24), dtype=torch.int8, generator=g)
    bias = torch.randn(32, generator=g)
    kw = dict(stride=stride, act='leaky', out_q=True)
    args = (w8, bias, 2.0 ** -9, 2.0 ** -4)
    want = fused_conv_int8_reference(x8, *args, **kw)
    h = 16 // n
    got = torch.cat([k2_rows(x8[:, r * h:(r + 1) * h].contiguous(), *args,
                             group=_Rows(x8, n, r),
                             conv=fused_conv_int8_reference, **kw)
                     for r in range(n)], 1)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize('size,stride', [(2, 1), (2, 2), (3, 2), (5, 1),
                                         (9, 1), (13, 1)])
def test_max_pool_rows_on_int8(size, stride, rows_in_one_process):
    """``max_pool_rows`` of each rank's rows of an int8 edge (pooled in f32,
    as ``max_pool_nhwc`` pools one: -inf has no int8 code), joined in rank
    order, equals ``max_pool_nhwc`` of the whole image, int8 and bit for
    bit, as NCHW and through ``max_pool_nhwc(group=...)``."""
    from yolo_tpu_torch.ops.conv import max_pool_nhwc, max_pool_rows
    x8 = torch.randint(-128, 128, (2, 16, 11, 8), dtype=torch.int8,
                       generator=torch.Generator().manual_seed(size))
    want = max_pool_nhwc(x8, size, stride)
    n, h = 2, 8
    blocks = [x8[:, r * h:(r + 1) * h].contiguous() for r in range(n)]
    nchw = torch.cat([max_pool_rows(b.permute(0, 3, 1, 2), size, stride,
                                    _Rows(x8, n, r)).permute(0, 2, 3, 1)
                      for r, b in enumerate(blocks)], 1)
    nhwc = torch.cat([max_pool_nhwc(b, size, stride, group=_Rows(x8, n, r))
                      for r, b in enumerate(blocks)], 1)
    for got in (nchw, nhwc):
        assert got.dtype == torch.int8 and torch.equal(got, want)


def test_tensor_parallel_quant_paths_still_raise(tmp_path):
    """What raised ``NotImplementedError`` until the port's last slice now
    runs: a QAT step under a mesh with a model axis
    (``make_train_functions(quant_apply=..., mesh=...)``) and a quantized
    ``evaluate`` over one, the google sim and the int8 engine. On a rank
    whose params are whole nothing is split, so no collective runs (the
    model group here is a stand-in): the step's loss items and gradients
    are one process's bit for bit, and both evaluations one process's
    results. ``tests/test_torch_tp_quant.py`` holds the split path to
    JAX's model mesh across ranks."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.eval.evaluator import evaluate, int8_engine_apply
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.parallel import Mesh
    from yolo_tpu_torch.train.loss import LossHyp, pad_targets
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    cfg = tmp_path / 'leaky.cfg'
    cfg.write_text(LEAKY_CFG)
    (tmp_path / 'names').write_text('a\nb\n')
    data = tmp_path / 'q.data'
    data.write_text(f'classes=2\nnames={tmp_path}/names\n')
    net = build_ir(str(cfg))
    tp = Mesh(shape={'data': 1, 'model': 2}, data_index=0, data_group=None,
              device=torch.device('cpu'), model_group=object())
    qcfg = TQ.QuantConfig(scheme='google', steps=10)
    qa = TQ.make_quant_apply(net, qcfg)
    avecs = [np.asarray(l.anchors) / l.yolo_stride for l in net.layers
             if l.kind == 'yolo']
    u8 = images(3, 2, 64)
    lab = [np.array([[0, .5, .5, .4, .3]], np.float32),
           np.array([[1, .3, .6, .2, .5]], np.float32)]
    tgt, valid = pad_targets(lab, 4)
    x = torch.from_numpy(u8.astype(np.float32) / 255.0)
    got = []
    for mesh in (None, tp):
        grad_fn, _ = make_train_functions(net, avecs, 2, LossHyp(),
                                          quant_apply=qa, mesh=mesh)
        ts = init_train_state(net, *from_jax(net, *random_jax_weights(
            net, seed=4)), compute_dtype=None, device='cpu',
            qstate=TQ.init_quant_state(net, qcfg)[0])
        ts, items = grad_fn(ts, x, torch.from_numpy(tgt),
                            torch.from_numpy(valid), 1.0, 1.0)
        out = {'items': items.numpy()}
        out.update({f'{k}/{f}': p.grad.numpy() for k, d in ts.params.items()
                    for f, p in d.items()})
        params = {k: {f: p.detach() for f, p in d.items()}
                  for k, d in ts.params.items()}
        plan, engine = int8_engine_apply(net, params, ts.bn_state,
                                         ts.qstate, qcfg, 'cpu')
        for tag, args in (('sim', (params, ts.bn_state, qa, ts.qstate)),
                          ('engine', (plan, {}, engine, None))):
            res, maps, _ = evaluate(
                net, args[0], args[1], str(data), batch_size=2, img_size=64,
                compute_dtype=torch.float32, loader=[(u8, tgt, valid,
                                                      ['a', 'b'], [None] * 2)],
                quant_apply=args[2], qstate=args[3], mesh=mesh,
                device='cpu')
            out[tag] = np.asarray(res + tuple(maps), np.float64)
        got.append(out)
    assert got[0].keys() == got[1].keys() and len(got[0]) > 20
    for k, v in got[0].items():
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--worker']:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
