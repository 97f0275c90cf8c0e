"""The port's tensor parallelism (the model axis of
``yolo_tpu_torch/parallel/mesh.py``, the split conv of
``models/network.py``, the TP step, checkpoint and evaluate) against the
JAX package's, on the CPU.

One job of four gloo ranks, a (data 2, model 2) mesh, started from this
file (``python tests/test_torch_tp.py --worker R PORT DIR``, no jax
there), runs every scenario once and writes each rank's results to an
``.npz``; meanwhile this process computes the references: the port in one
process, and JAX on its 8 virtual CPU devices.

- ``state_shardings`` on yolov3-tiny at tp 2: the same leaves split as
  JAX's, leaf by leaf.
- One f32 yolov3-tiny step at 64 px, global bs 8, against JAX's
  ``_one_step`` on a (4, 2) mesh (``tests/test_parallel.py``) and the
  port's step without a mesh: the loss items within rtol 2e-4 / atol
  2e-5, the updated params, once gathered, within rtol 1e-3 / atol 1e-4
  (JAX's own DP against TP tolerances). The checkpoint written under TP
  (whole tensors, rank 0 alone) loads in one process and in JAX.
- The KD5 step of ``TOY_CFG`` (``test_torch_parallel.py``'s: the student
  split, the teacher whole on every rank) under TP against one process and
  JAX's 2-device mesh, by the same tolerances.
- ``evaluate(mesh=...)`` at tp 2 on the 9-file set against one process,
  f32, by ``test_torch_parallel.py``'s tolerances.
- The leaves every rank holds whole (the head convs) stay equal on all
  ranks when one model rank's backward gives them other gradients.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import (LOSS_TOL, PARAM_TOL, block, free_port,
                                 global_batch, port_eval, port_step, spawn,
                                 wait, write_set)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RANKS, TP = 4, 2
TINY = os.path.join(ROOT, 'cfg', 'yolov3tiny', 'yolov3-tiny.cfg')
TINY_BS, TINY_SIZE = 8, 64
TOY_STEPS = ('kd',)


# ------------------------------------------------------------ yolov3-tiny

def tiny_batch():
    """``tests/test_parallel.py::_one_step``'s batch: images, targets (one
    box an image) and their mask, numpy."""
    x = np.random.RandomState(0).rand(TINY_BS, TINY_SIZE, TINY_SIZE,
                                      3).astype(np.float32)
    t = np.zeros((16, 6), np.float32)
    t[:TINY_BS, 0] = np.arange(TINY_BS)
    t[:TINY_BS, 1:] = [1, .5, .5, .2, .2]
    return x, t, np.arange(16) < TINY_BS


def tiny_step(root, mesh=None):
    """One f32 SGD step of yolov3-tiny from ``root/tiny_init.npz`` (on this
    rank's data block under ``mesh``): the global loss items, the whole
    params flat, and, under a model axis, how many leaves each rank holds
    split; writes ``root/tp.npz`` (rank 0, whole tensors)."""
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.parallel import gather_state, shard_state
    from yolo_tpu_torch.parallel.collectives import all_reduce_nograd
    from yolo_tpu_torch.train.loop import save_train_checkpoint
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.schedules import burn_in_scalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    net = build_ir(TINY)
    ck = load_checkpoint(os.path.join(root, 'tiny_init.npz'))
    avecs = [np.asarray(l.anchors) / l.yolo_stride for l in net.layers
             if l.kind == 'yolo']
    grad_fn, update_fn = make_train_functions(net, avecs, 80, LossHyp(),
                                              mesh=mesh)
    ts = init_train_state(net, *from_jax(net, ck['params'], ck['state']),
                          compute_dtype=None, device='cpu')
    whole_shapes = {(k, f): p.shape for k, d in ts.params.items()
                    for f, p in d.items()}
    x, t, v = tiny_batch()
    if mesh is not None:
        shard_state(mesh, net, ts)
        lb = TINY_BS // mesh.shape['data']
        mine = v & (t[:, 0] // lb == mesh.data_index)
        t = np.where(mine[:, None], t - [mesh.data_index * lb, 0, 0, 0, 0,
                                         0], 0).astype(np.float32)
        x, v = x[mesh.data_index * lb:(mesh.data_index + 1) * lb], mine
    sc, gr, _ = burn_in_scalars(1000, 500, 0, lr0=0.01, momentum=0.937,
                                weight_decay=5e-4, epochs=10,
                                batch_size=TINY_BS)
    ts, items = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(t),
                        torch.from_numpy(v), gr, 1.0)
    ts = update_fn(ts, sc)
    out = {'items': all_reduce_nograd(
        items, None if mesh is None else mesh.data_group).numpy()}
    out['split'] = np.array(sum(p.shape != whole_shapes[(k, f)]
                                for k, d in ts.params.items()
                                for f, p in d.items()))
    out['momentum_split'] = np.array(sum(
        st['momentum_buffer'].shape != whole_shapes[(k, f)]
        for g in ts.optimizer.param_groups
        for p, (k, f) in zip(g['params'], g['keys'])
        for st in [ts.optimizer.state[p]]))
    for k, d in gather_state(mesh, net, ts.params).items():
        for f, p in d.items():
            out[f'p/{k}/{f}'] = p.detach().numpy().copy()
    if mesh is not None:
        save_train_checkpoint(os.path.join(root, 'tp.npz'), ts, net,
                              epoch=0, best_fitness=0.0, results_file='',
                              with_opt=True, mesh=mesh)
    return out


def replica_step(root, mesh):
    """A TP step of yolov3-tiny in which model rank 1 adds 1e-3 to the
    gradient of every leaf held whole (the convs whose filters do not
    split), as a backward that sums in another order would set it apart:
    those leaves and their momentum after ``update_fn``."""
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.parallel import shard_state
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.optim import PerGroupScalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    net = build_ir(TINY)
    ck = load_checkpoint(os.path.join(root, 'tiny_init.npz'))
    avecs = [np.asarray(l.anchors) / l.yolo_stride for l in net.layers
             if l.kind == 'yolo']
    grad_fn, update_fn = make_train_functions(net, avecs, 80, LossHyp(),
                                              mesh=mesh)
    ts = init_train_state(net, *from_jax(net, ck['params'], ck['state']),
                          compute_dtype=None, device='cpu')
    shard_state(mesh, net, ts)
    x, t, v = block(*tiny_batch(), mesh.data_index)
    ts, _ = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(v), 1.0, 1.0)
    whole = [str(l.index) for l in net.layers
             if l.kind == 'conv' and l.filters % TP]
    with torch.no_grad():
        for k in whole:
            for p in ts.params[k].values():
                p.grad += 1e-3 * mesh.model_index
    ts = update_fn(ts, PerGroupScalars(lr=(0.01,) * 4,
                                       weight_decay=(5e-4, 0.0, 0.0, 0.0),
                                       momentum=0.937))
    out = {'n': np.array(len(whole))}
    for k in whole:
        for f, p in ts.params[k].items():
            out[f'p/{k}/{f}'] = p.detach().numpy().copy()
            out[f'm/{k}/{f}'] = ts.optimizer.state[p][
                'momentum_buffer'].numpy().copy()
    return out


def worker(rank, port, root):
    """One rank of the job: every scenario, into ``root/rank{rank}.npz``."""
    from yolo_tpu_torch.parallel import init_multihost, make_mesh
    torch.set_num_threads(1)
    dev = init_multihost(f'localhost:{port}', RANKS, rank, device='cpu')
    mesh = make_mesh(dev, model_parallel=TP)
    out = {'mesh': np.array([mesh.data_index, mesh.model_index,
                             mesh.shape['data'], mesh.shape['model']])}
    out.update({f'tiny/{k}': v for k, v in tiny_step(root, mesh).items()})
    out.update({f'replica/{k}': v
                for k, v in replica_step(root, mesh).items()})
    cfgs = {k: os.path.join(root, f'{k}.cfg') for k in ('toy', 'plain')}
    datas = {k: os.path.join(root, f'{k}.data') for k in ('eval', 'train')}
    xb, tb, vb = global_batch()
    for kind in TOY_STEPS:
        out.update({f'{kind}/{k}': v for k, v in port_step(
            kind, cfgs, *block(xb, tb, vb, mesh.data_index),
            mesh=mesh).items()})
    os.chdir(os.path.join(root, f'rank{rank}'))
    out.update({f'eval/{k}': v for k, v in
                port_eval(cfgs, datas, mesh).items()})
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(root, f'rank{rank}.npz'), **out)


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """Write the inputs, start the job; yields (root, cfgs, datas, wait)
    where wait() returns the ranks' results."""
    import jax
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu.models.network import init_params as jinit
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    root = str(tmp_path_factory.mktemp('tp'))
    cfgs, datas, _ = write_set(root)
    p, s = jinit(jax.random.PRNGKey(0), jbuild(TINY))
    save_checkpoint(os.path.join(root, 'tiny_init.npz'),
                    params=jax.device_get(p), state=jax.device_get(s))
    for r in range(RANKS):
        os.makedirs(os.path.join(root, f'rank{r}'))
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
        yield root, cfgs, datas, wait_all
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def ranks_equal(res, prefix):
    keys = [k for k in res[0] if k.startswith(prefix)]
    assert keys
    for r in range(1, RANKS):
        for k in keys:
            np.testing.assert_array_equal(res[0][k], res[r][k], err_msg=k)
    return keys


# ------------------------------------------------------------ one process

def test_state_shardings_match_jax():
    """The leaves split over the model axis at tp 2 on yolov3-tiny, leaf by
    leaf, are JAX's (``tests/test_parallel.py``'s count and head rule)."""
    import jax
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu.models.network import init_params as jinit
    from yolo_tpu.parallel import make_mesh as jmesh
    from yolo_tpu.parallel import state_shardings as jshardings
    from yolo_tpu.parallel.mesh import MODEL_AXIS as JMODEL
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.parallel import MODEL_AXIS, Mesh, state_shardings
    jnet, net = jbuild(TINY), build_ir(TINY)
    pj, sj = jinit(jax.random.PRNGKey(0), jnet)
    jsh = jshardings(jmesh(jax.devices(), model_parallel=2), jnet,
                     {'params': pj, 'state': sj})
    mesh = Mesh(shape={'data': 1, 'model': 2}, data_index=0, data_group=None,
                device=torch.device('cpu'))
    p, s = from_jax(net, jax.device_get(pj), jax.device_get(sj))
    sh = state_shardings(mesh, net, {'params': p, 'state': s})
    n = 0
    for tree in ('params', 'state'):
        assert sh[tree].keys() == jsh[tree].keys()
        for k, d in sh[tree].items():
            assert d.keys() == jsh[tree][k].keys()
            for f, spec in d.items():
                want = JMODEL in jax.tree_util.tree_leaves(
                    tuple(jsh[tree][k][f].spec))
                assert (MODEL_AXIS in spec.spec) == want, (tree, k, f)
                n += want
    assert n > 10
    heads = [str(l.index) for l in net.layers if l.kind == 'conv'
             and l.smart_bias]
    assert heads and all(sh['params'][k]['w'].spec == () for k in heads)


def test_make_mesh_model_axis_needs_ranks():
    """``make_mesh(model_parallel=2)`` in one process raises ValueError, as
    JAX's assertion; a model axis of 1 is the one-rank mesh."""
    from yolo_tpu_torch.parallel import MODEL_AXIS, make_mesh
    with pytest.raises(ValueError, match='model_parallel=2'):
        make_mesh('cpu', model_parallel=2)
    m = make_mesh('cpu', model_parallel=1)
    assert m.shape[MODEL_AXIS] == 1 and m.model_group is None


# ------------------------------------------------------------ the job

@pytest.fixture(scope='module')
def references(job):
    """JAX's TP step of yolov3-tiny, the port's step without a mesh, and
    the toy steps in one process and on JAX's 2-device mesh (computed while
    the job runs)."""
    import jax
    from test_parallel import _one_step
    from test_torch_parallel import jax_step
    from yolo_tpu.parallel import make_mesh as jmesh
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    root, cfgs = job[0], job[1]
    prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        jnet, jts, jitems = _one_step(ROOT, jmesh(jax.devices(),
                                                  model_parallel=2))
        p, _ = from_jax(build_ir(TINY), jax.device_get(jts.params), {})
        jx = {'items': np.asarray(jitems)}
        jx.update({f'p/{k}/{f}': t.numpy() for k, d in p.items()
                   for f, t in d.items()})
        xb, tb, vb = global_batch()
        toy = {kind: (port_step(kind, cfgs, xb, tb, vb),
                      jax_step(kind, cfgs, xb, tb, vb)) for kind in TOY_STEPS}
        return {'tiny': (tiny_step(root), jx), **toy}
    finally:
        jax.config.update('jax_default_matmul_precision', prec)
        torch.set_num_threads(threads)


def test_mesh_layout(job):
    """Rank r sits at data r // 2, model r % 2 of a (2, 2) mesh."""
    res = job[3]()
    for r in range(RANKS):
        assert res[r]['mesh'].tolist() == [r // TP, r % TP, RANKS // TP, TP]


def test_tiny_step_matches_jax(job, references):
    """Every rank ends with the same whole params; each holds the split
    leaves (and their momentum) as blocks; the loss items and the params
    match JAX's DP x TP step and the port's step without a mesh."""
    res = job[3]()
    keys = ranks_equal(res, 'tiny/p/') + ranks_equal(res, 'tiny/items')
    assert int(res[0]['tiny/split']) > 10
    assert res[0]['tiny/momentum_split'] == res[0]['tiny/split']
    single, jx = references['tiny']
    for ref in (single, jx):
        np.testing.assert_allclose(res[0]['tiny/items'], ref['items'],
                                   **LOSS_TOL)
        for k in keys:
            if k != 'tiny/items':
                np.testing.assert_allclose(res[0][k], ref[k[5:]],
                                           **PARAM_TOL, err_msg=k)


def test_replicated_leaves_stay_equal(job):
    """Model rank 1's other gradients of the head convs (held whole on
    every rank) are averaged over the model group by ``update_fn``: the
    head convs and their momentum come out equal on all four ranks."""
    res = job[3]()
    assert int(res[0]['replica/n']) == 2
    keys = ranks_equal(res, 'replica/')
    assert len(keys) == 1 + 2 * 2 * 2


def test_tp_checkpoint_loads_in_one_process_and_jax(job):
    """``save_train_checkpoint`` under TP holds whole tensors: the port's
    ``load_model`` and JAX's load them, equal to the gathered params."""
    import jax.numpy as jnp
    from yolo_tpu import runtime as jrt
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    root = job[0]
    res = job[3]()
    path = os.path.join(root, 'tp.npz')
    ck = load_checkpoint(path)
    assert ck['opt_state'] is not None
    b = trt.load_model(TINY, path, device='cpu', dtype=torch.float32,
                       prefer_ema=False)
    jb = jrt.load_model(TINY, path, compute_dtype=jnp.float32,
                        prefer_ema=False)
    jp, _ = from_jax(b.net, jb.params, {})
    for k, d in b.params.items():
        for f, t in d.items():
            np.testing.assert_array_equal(t.numpy(), res[0][f'tiny/p/{k}/{f}'])
            np.testing.assert_array_equal(jp[k][f].numpy(), t.numpy())


@pytest.mark.parametrize('kind', TOY_STEPS)
def test_toy_step_under_tp(kind, job, references):
    """The KD5 step of ``TOY_CFG`` under TP: every rank equal, against one
    process and JAX's 2-device mesh."""
    res = job[3]()
    keys = ranks_equal(res, f'{kind}/')
    single, jx = references[kind]
    got = {k[len(kind) + 1:]: res[0][k] for k in keys}
    assert got.keys() == single.keys()
    for ref in (single, jx):
        np.testing.assert_allclose(got['items'], ref['items'], **LOSS_TOL)
        for k in got:
            if k != 'items':
                np.testing.assert_allclose(got[k], ref[k], **PARAM_TOL,
                                           err_msg=k)


def test_evaluate_under_tp(job):
    """``evaluate(mesh=...)`` at tp 2 on split weights: every rank's results
    equal, against one process by ``test_torch_parallel.py``'s f32
    tolerances; rank 0 alone plots."""
    root, cfgs, datas, wait_all = job
    res = wait_all()
    ranks_equal(res, 'eval/')
    single = port_eval(cfgs, datas)
    got = res[0]['eval/res']
    assert got[2] > 0
    np.testing.assert_allclose(got[:4], single['res'][:4], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got[4:], single['res'][4:], rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(res[0]['eval/maps'], single['maps'],
                               rtol=1e-6, atol=1e-9)
    assert os.path.exists(os.path.join(root, 'rank0', 'test_batch0_gt.jpg'))
    for r in range(1, RANKS):
        assert not os.path.exists(os.path.join(root, f'rank{r}',
                                               'test_batch0_gt.jpg'))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--worker']:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
