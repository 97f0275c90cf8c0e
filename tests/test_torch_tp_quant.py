"""The port's QAT under tensor parallelism (``make_quant_apply(...,
model_group=...)`` in the train step, ``train --tp K --quantized N``) and
the quantized ``evaluate`` over a model axis, against the JAX package's
GSPMD path and against one process, on the CPU.

One job of two gloo ranks, a (data 1, model 2) mesh, started from this file
(``python tests/test_torch_tp_quant.py --worker R PORT DIR``, no jax
there), runs every scenario once and writes each rank's results to an
``.npz``, and a second job runs ``python -m yolo_tpu_torch.train
--coordinator ... --tp 2 --quantized 1``; meanwhile this process computes
the references: the port in one process, and JAX on a 2-device model mesh
of its 8 virtual CPU devices (``make_mesh(model_parallel=2)``), where XLA
makes every reduction of the quantizer global, in three processes of
their own.

- Every scheme on ``PLAIN_CFG`` (whose QAT train forward is JAX's, see
  ``test_torch_quant_schemes.py``), global bs 8 at 64 px, f32: one QAT
  step, then one BN-frozen step (``make_bn_frozen``). After each, the
  loss items within rtol 2e-4 / atol 2e-5, the params, BN state and EMA,
  gathered, within rtol 1e-3 / atol 1e-4 (``test_torch_tp.py``'s), of
  one process's, and after the first step of JAX's (after both for
  google: the BN-frozen fold is one code for every scheme);
  ``qstate`` bit-equal on both ranks and within the same tolerances of
  the references; TPSQ's ``w_scale`` / ``b_scale`` / ``a_scale``
  gradients of the first step equal to one process's within the params'
  tolerance. DoReFa's weights are not powers
  of two: the frameworks' conv sums round apart, an activation on a
  boundary of its 255 levels lands a level apart
  (``test_torch_quant_schemes.HEAD_OFF``), and JAX's own jitted and eager
  steps differ as much as either differs from the port's one process. So
  DoReFa's step is held to JAX's by ``DOREFA_JAX_TOL`` (the loss items
  rtol 2e-3, each leaf within 2e-3 of its norm), and to one process by
  the tolerances above. Binary weights (``wbin``) are ±1 without a scale: the
  toy's head maps reach ~1e7, the box loss's ``exp`` overflows and the
  first step's gradient is NaN in one process and in JAX alike, so its
  first loss items, BN state and ``qstate`` are held, and its params are
  NaN in all three.
- google with ``remat='blocks'`` (the quant apply recomputed in the
  backward, its collectives run again): bit-equal to the step without.
- The TPSQ warmup search under the model group on the split params: the
  scales of one process's ``tpsq_warmup`` on the whole params, within
  rtol 1e-6 (a candidate is i/100 of the maximum, which carries the
  rounding of the BN fold's statistics conv on a block of the filters).
- google on yolov3-tiny at 64 px, global bs 8: one QAT step against one
  process by the same tolerances. Against JAX's 2-way model mesh by
  ``TINY_JAX_TOL``: at 64 px its deep convs see 2x2 maps, so their BN
  batch statistics come from 32 values a channel, and where the two
  frameworks' conv sums round an activation a quantum apart (a few values
  of layer 6), the statistics, and with them the folded weights of the
  layers after it, move (a seventh of layer 14's values a quantum apart);
  the port's one process is as far from JAX's one device. So the loss
  items are held within rtol 2e-3 and all params together within 1e-3 of
  their norm (a BN beta, 0 before the step, is the step's update alone,
  and those updates differ by up to a tenth).
- The google run's checkpoint, written by rank 0 with the whole tensors
  and ``qstate``, loads in one process and in JAX.
- ``evaluate(mesh=...)`` at tp 2 on the 9-file set from that checkpoint's
  EMA pair: the google sim on the split params against one process on the
  whole (rtol 1e-6 / atol 1e-9, the val losses 1e-5), and the int8 engine
  (its plan whole on each rank) equal to one process's; a plan built from
  a rank's blocks is refused.
- The train CLI on two ranks for an epoch of the 16-file set (two steps,
  the second after the BN freeze, the epoch's sim ``evaluate`` over the
  model axis): the same loss lines on both ranks, the checkpoint whole
  with ``qstate`` from rank 0 alone, its results row against one
  process's (``--no-mesh``) by ``test_torch_parallel.py``'s CLI
  tolerance.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import (BS, CLI_TOL, LOSS_TOL, NC, PARAM_TOL,
                                 PLAIN_CFG, SIZE, anchor_vecs, flat,
                                 free_port, global_batch, hyp, spawn, wait,
                                 write_set)
from test_torch_tp import TINY, tiny_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RANKS, TP = 2, 2
SCHEMES = ('google', 'tpsq', 'ptq_cos', 'dorefa', 'wbin', 'ternary')
QSTEPS = 10
# the seed of the toy's weights: the google run's detections then match
# some of the 9-file set's random boxes (its mAP above 0), so that the
# evaluation's matching has work
INIT_SEED = 5
# DoReFa's step against JAX's (module docstring): the loss items' rtol, and
# each leaf's distance to JAX's over JAX's norm
DOREFA_JAX_TOL = dict(items=2e-3, norm=2e-3)
# the schemes whose BN-frozen step is also held to JAX's: the fold on the
# running statistics is one code for every scheme (the others' frozen
# steps are held to one process)
JAX_FROZEN = ('google',)
# yolov3-tiny's step against JAX's (module docstring): the loss items' rtol,
# and the distance of all params together over their norm
TINY_JAX_TOL = dict(items=2e-3, norm=1e-3)
SCALES = ('w_scale', 'b_scale', 'a_scale')


def scalars():
    from yolo_tpu_torch.train.schedules import burn_in_scalars
    return burn_in_scalars(1000, 500, 0, lr0=0.01, momentum=0.937,
                           weight_decay=5e-4, epochs=10, batch_size=BS)


def init_weights(root, scheme):
    """JAX-layout numpy (params, state) of ``PLAIN_CFG`` for ``scheme``:
    the seeded toy weights with the scheme's extra params, TPSQ's from one
    process's ``tpsq_warmup`` on the global batch (as the train loop runs
    it, before the state is split)."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax, to_jax
    from yolo_tpu_torch.ir import build_ir
    from _torch_port import random_jax_weights
    net = build_ir(os.path.join(root, 'plain.cfg'))
    pj, sj = random_jax_weights(net, seed=INIT_SEED, conv_scale=0.7)
    if scheme != 'tpsq':
        return pj, sj
    qcfg = TQ.QuantConfig(scheme=scheme, steps=QSTEPS)
    qs, extra = TQ.init_quant_state(net, qcfg)
    p, s = from_jax(net, pj, sj)
    for k, e in extra.items():
        p[k].update(e)
    p = TQ.tpsq_warmup(net, qcfg, p, s, qs, torch.from_numpy(
        global_batch()[0]))
    return to_jax(net, p, s)


def port_qat(root, scheme, mesh=None, remat=None, init=None,
             cfg='plain.cfg', batch=None, steps=2):
    """``steps`` f32 QAT steps (SGD) of ``scheme`` from ``root/init``
    (default ``{scheme}_init.npz``) on ``cfg`` and the global ``batch``
    (default ``global_batch()``, 2 classes; else 80): the first through
    the step with the BN statistics conv, the second through the
    BN-frozen one. Returns, flat, the loss items of each step
    (``items{i}``), TPSQ's scale gradients of the first (``g/``), and
    after each step ``i`` the params, BN state, EMA (gathered whole) and
    ``qstate`` (``{i}/p/``, ``{i}/s/``, ``{i}/ep/``, ``{i}/es/``,
    ``{i}/q/``); and the train state and the net."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax, qstate_to_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.parallel import gather_state, shard_state
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    net = build_ir(cfg if os.path.isabs(cfg) else os.path.join(root, cfg))
    ck = load_checkpoint(os.path.join(root, init or f'{scheme}_init.npz'))
    qcfg = TQ.QuantConfig(scheme=scheme, steps=QSTEPS)
    qstate = TQ.init_quant_state(net, qcfg)[0]
    apply = TQ.make_quant_apply(net, qcfg, head_layout='nhwc')
    nc = NC if batch is None else 80
    avecs = anchor_vecs(net)
    lh = LossHyp.from_dict(hyp(), nc=nc)
    fns = [make_train_functions(net, avecs, nc, lh, quant_apply=a,
                                mesh=mesh, remat=remat)
           for a in (apply, apply.make_bn_frozen())]
    ts = init_train_state(net, *from_jax(net, ck['params'], ck['state']),
                          compute_dtype=None, device='cpu', qstate=qstate)
    if mesh is not None:
        shard_state(mesh, net, ts)
    x, t, v = global_batch() if batch is None else batch
    sc, gr, _ = scalars()
    out = {}
    for i in range(steps):
        grad_fn, update_fn = fns[i]
        ts, items = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(t),
                            torch.from_numpy(v), gr,
                            BS / 64.0)
        out[f'items{i}'] = items.numpy().copy()
        if i == 0:
            for k, d in ts.params.items():
                for f in SCALES:
                    if f in d:
                        out[f'g/{k}/{f}'] = d[f].grad.numpy().copy()
        ts = update_fn(ts, sc)
        whole = lambda tree: gather_state(mesh, net, tree)
        for tag, tree in (('p', whole(ts.params)),
                          ('s', whole(ts.bn_state)),
                          ('ep', whole(ts.ema.params)),
                          ('es', whole(ts.ema.state))):
            for k, d in tree.items():
                for f, t_ in d.items():
                    out[f'{i}/{tag}/{k}/{f}'] = t_.detach().numpy().copy()
        out.update(flat(qstate_to_jax(ts.qstate), f'{i}/q'))
    return out, ts, net


def jax_qat(root, scheme, init=None, cfg='plain.cfg', batch=None,
            steps=2):
    """JAX's ``port_qat`` on a 2-device model mesh (``make_mesh(...,
    model_parallel=2)``): the loss items of each step and the params, BN
    state, EMA and ``qstate`` in the port's keys and layout (after
    ``steps`` steps)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    from yolo_tpu.parallel import make_mesh, shard_batch, shard_state
    from yolo_tpu.train.loss import LossHyp as JHyp
    jax.config.update('jax_default_matmul_precision', 'highest')
    from yolo_tpu.train.trainer import init_train_state, make_train_functions
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    net = build_ir(cfg if os.path.isabs(cfg) else os.path.join(root, cfg))
    ck = load_checkpoint(os.path.join(root, init or f'{scheme}_init.npz'))
    qcfg = JQ.QuantConfig(scheme=scheme, steps=QSTEPS)
    apply = JQ.make_quant_apply(net, qcfg, compute_dtype=jnp.float32,
                                head_layout='nhwc')
    nc = NC if batch is None else 80
    lh = JHyp.from_dict(hyp(), nc=nc)
    fns = [make_train_functions(net, anchor_vecs(net), nc, lh,
                                compute_dtype=None, quant_apply=a)
           for a in (apply, apply.make_bn_frozen())[:steps]]
    ts = init_train_state(jax.tree.map(jnp.asarray, ck['params']),
                          jax.tree.map(jnp.asarray, ck['state']),
                          qstate=JQ.init_quant_state(net, qcfg)[0])
    x, t, v = global_batch() if batch is None else batch
    sc, gr, _ = scalars()
    mesh = make_mesh(jax.devices()[:TP], model_parallel=TP)
    out = {}
    with mesh:
        ts = shard_state(mesh, net, ts)
        for i in range(steps):
            grad_fn, update_fn = fns[i]
            ts, items = grad_fn(ts, shard_batch(mesh, jnp.asarray(x)),
                                jnp.asarray(t), jnp.asarray(v), gr,
                                BS / 64.0)
            out[f'items{i}'] = np.asarray(items)
            ts = update_fn(ts, sc)
            host = jax.device_get(ts)
            for tag, (p, s) in (('', (host.params, host.bn_state)),
                                ('e', (host.ema.params, host.ema.state))):
                tp, tsd = from_jax(net, p, s)
                for k, d in tp.items():
                    for f, t_ in d.items():
                        out[f'{i}/{tag}p/{k}/{f}'] = t_.numpy()
                for k, d in tsd.items():
                    for f, t_ in d.items():
                        out[f'{i}/{tag}s/{k}/{f}'] = t_.numpy()
            out.update(flat(host.qstate, f'{i}/q'))
    return out


def warmup_split(root, mesh):
    """TPSQ's warmup apply under the model group on this rank's blocks of
    the pre-warmup params: the scales it finds (whole on every rank)."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.parallel import shard_state
    from _torch_port import random_jax_weights
    net = build_ir(os.path.join(root, 'plain.cfg'))
    pj, sj = random_jax_weights(net, seed=INIT_SEED, conv_scale=0.7)
    qcfg = TQ.QuantConfig(scheme='tpsq', steps=QSTEPS)
    qs, extra = TQ.init_quant_state(net, qcfg)
    p, s = from_jax(net, pj, sj)
    for k, e in extra.items():
        p[k].update(e)
    shard_state(mesh, net, p)
    shard_state(mesh, net, s)
    apply = TQ.make_quant_apply(net, qcfg, warmup=True)
    with torch.no_grad():
        _, _, new_q = apply(p, s, qs, torch.from_numpy(global_batch()[0]),
                            True, model_group=mesh.model_group)
    return {f'{k}/{f}': q[f].numpy() for k, q in new_q.items()
            for f in SCALES if f in q}


def port_eval(root, ck_path, mesh=None):
    """``evaluate`` of the 9-file set in f32 with val losses, bs 2, of the
    google checkpoint's EMA pair: the sim (on the split params under
    ``mesh``) and the int8 engine (its plan from the whole params)."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.eval.evaluator import evaluate, int8_engine_apply
    from yolo_tpu_torch.parallel import shard_state
    from yolo_tpu_torch.train.loss import LossHyp
    b = trt.load_model(os.path.join(root, 'plain.cfg'), ck_path,
                       device='cpu', dtype=torch.float32, quantized=1,
                       steps=QSTEPS)
    plan, engine = int8_engine_apply(b.net, b.params, b.state, b.qstate,
                                     b.qcfg, 'cpu')
    params, state = b.params, b.state
    if mesh is not None:
        params = shard_state(mesh, b.net, {k: dict(v)
                                           for k, v in params.items()})
        state = shard_state(mesh, b.net, {k: dict(v)
                                          for k, v in state.items()})
    kw = dict(batch_size=2, img_size=SIZE, compute_dtype=torch.float32,
              loss_hyp=LossHyp.from_dict(hyp(), nc=NC),
              anchor_vecs=anchor_vecs(b.net), mesh=mesh, device='cpu')
    data = os.path.join(root, 'eval.data')
    out = {}
    for tag, args in (('sim', (params, state, b.quant_apply(), b.qstate)),
                      ('engine', (plan, {}, engine, None))):
        res, maps, _ = evaluate(b.net, args[0], args[1], data,
                                quant_apply=args[2], qstate=args[3], **kw)
        out[f'{tag}/res'] = np.asarray(res, np.float64)
        out[f'{tag}/maps'] = np.asarray(maps)
    return out


def worker(rank, port, root):
    """One rank of the job: every scenario, into ``root/rank{rank}.npz``."""
    from yolo_tpu_torch.parallel import init_multihost, make_mesh
    from yolo_tpu_torch.train.loop import save_train_checkpoint
    torch.set_num_threads(1)
    dev = init_multihost(f'localhost:{port}', RANKS, rank, device='cpu')
    mesh = make_mesh(dev, model_parallel=TP)
    out = {'mesh': np.array([mesh.data_index, mesh.model_index,
                             mesh.shape['data'], mesh.shape['model']])}
    for scheme in SCHEMES:
        res, ts, net = port_qat(root, scheme, mesh)
        out.update({f'{scheme}/{k}': v for k, v in res.items()})
        if scheme == 'google':
            save_train_checkpoint(os.path.join(root, 'tpq.npz'), ts, net,
                                  epoch=0, best_fitness=0.0,
                                  results_file='', with_opt=False,
                                  mesh=mesh)
    for tag, remat in (('google1', None), ('remat', 'blocks')):
        res = port_qat(root, 'google', mesh, remat=remat, steps=1)[0]
        out.update({f'{tag}/{k}': v for k, v in res.items()})
    out.update({f'warmup/{k}': v for k, v in warmup_split(root,
                                                          mesh).items()})
    res = port_qat(root, 'google', mesh, init='tiny_init.npz', cfg=TINY,
                   batch=tiny_batch(), steps=1)[0]
    out.update({f'tiny/{k}': v for k, v in res.items()})
    os.chdir(os.path.join(root, f'rank{rank}'))
    out.update({f'eval/{k}': v for k, v in port_eval(
        root, os.path.join(root, 'tpq.npz'), mesh).items()})
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(root, f'rank{rank}.npz'), **out)


# ------------------------------------------------------------ the job

def cli_args(root):
    """``train --tp 2 --quantized 1`` in f32 for an epoch of the 16-file set
    (two steps, the second after the BN freeze) from the google init."""
    return ['--cfg', os.path.join(root, 'plain.cfg'), '--data',
            os.path.join(root, 'train.data'), '--weights',
            os.path.join(root, 'google_init.npz'), '--epochs', '1',
            '--batch-size', str(BS), '--img-size', str(SIZE), '--tp', str(TP),
            '--quantized', '1', '--qat-dtype', 'f32', '--device', 'cpu']


def start_job(root):
    """Write the inputs into ``root`` and start the job; returns (wait,
    the ranks' processes), where wait() returns the ranks' results."""
    import jax
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu.models.network import init_params as jinit
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    write_set(root)
    for scheme in SCHEMES:
        p, s = init_weights(root, scheme)
        save_checkpoint(os.path.join(root, f'{scheme}_init.npz'), params=p,
                        state=s)
    p, s = jinit(jax.random.PRNGKey(0), jbuild(TINY))
    save_checkpoint(os.path.join(root, 'tiny_init.npz'),
                    params=jax.device_get(p), state=jax.device_get(s))
    for r in range(RANKS):
        os.makedirs(os.path.join(root, f'rank{r}'))
        os.makedirs(os.path.join(root, f'cli{r}'))
    port = free_port()
    procs = spawn(lambda r: [sys.executable, os.path.abspath(__file__),
                             '--worker', str(r), str(port), root],
                  lambda r: root, n=RANKS)
    port2 = free_port()
    cli = spawn(lambda r: [sys.executable, '-m', 'yolo_tpu_torch.train',
                           '--coordinator', f'localhost:{port2}',
                           '--num-hosts', str(RANKS), '--host-id', str(r)]
                + cli_args(root),
                lambda r: os.path.join(root, f'cli{r}'), n=RANKS)
    done = []

    def wait_all():
        if not done:
            wait(procs)
            done.append([dict(np.load(os.path.join(root, f'rank{r}.npz')))
                         for r in range(RANKS)])
            done.append(wait(cli))
        return done[0]
    wait_all.cli = lambda: wait_all() and done[1]
    return wait_all, procs + cli


@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """The started job: yields (root, wait)."""
    root = str(tmp_path_factory.mktemp('tpq'))
    wait_all, procs = start_job(root)
    try:
        yield root, wait_all
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _jax_on_cpu():
    """A reference process's JAX on the CPU, with ``tests/conftest.py``'s
    8 virtual devices (its ``XLA_FLAGS`` are inherited)."""
    import jax
    jax.config.update('jax_platforms', 'cpu')


@pytest.fixture(scope='module')
def references(job):
    """Each scheme's steps in one process and on JAX's 2-device model mesh,
    and the yolov3-tiny step likewise, computed while the job runs: JAX's
    in three processes of their own (its tracing holds the GIL), at
    'highest' matmul precision."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    root = job[0]
    tiny = dict(init='tiny_init.npz', cfg=TINY, batch=tiny_batch(), steps=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with ProcessPoolExecutor(3, multiprocessing.get_context('spawn'),
                                 initializer=_jax_on_cpu) as pool:
            # the longest first
            jx = {'tiny': pool.submit(jax_qat, root, 'google', **tiny)}
            for s in sorted(SCHEMES, key=lambda s: s not in JAX_FROZEN):
                jx[s] = pool.submit(jax_qat, root, s,
                                    steps=2 if s in JAX_FROZEN else 1)
            single = {s: port_qat(root, s)[0] for s in SCHEMES}
            single['tiny'] = port_qat(root, 'google', **tiny)[0]
            return {k: (single[k], f.result()) for k, f in jx.items()}
    finally:
        torch.set_num_threads(threads)


def ranks_equal(res, prefix):
    keys = [k for k in res[0] if k.startswith(prefix)]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
    return keys


def _tol(key):
    return LOSS_TOL if key.startswith('items') else PARAM_TOL


def _close_to_jax(got, want, scheme):
    for k, w in want.items():
        if scheme != 'dorefa':
            np.testing.assert_allclose(got[k], w, **_tol(k), err_msg=k)
        elif k.startswith('items'):
            np.testing.assert_allclose(got[k], w,
                                       rtol=DOREFA_JAX_TOL['items'],
                                       err_msg=k)
        else:
            d = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
            assert d <= DOREFA_JAX_TOL['norm'], (k, d)


def test_mesh_layout(job, references):
    """Rank r sits at data 0, model r of a (1, 2) mesh (the references are
    asked for first, so that they are computed while the job runs)."""
    res = job[1]()
    for r in range(RANKS):
        assert res[r]['mesh'].tolist() == [0, r, 1, TP]


@pytest.mark.parametrize('scheme', SCHEMES)
def test_qat_steps_under_tp(scheme, job, references):
    """A QAT step and a BN-frozen step under tp 2: both ranks end with the
    same whole params and bit-equal ``qstate``; the loss items, params, BN
    state, EMA and ``qstate`` against one process and JAX's 2-way model
    mesh (module docstring); TPSQ's scale gradients against one
    process's."""
    res = job[1]()
    keys = ranks_equal(res, f'{scheme}/')
    got = {k[len(scheme) + 1:]: res[0][k] for k in keys}
    single, jx = references[scheme]
    assert got.keys() == single.keys()
    assert set(jx) == {k for k in got if not k.startswith('g/') and (
        scheme in JAX_FROZEN or k[0] == '0' or k == 'items0')}
    assert any(k.startswith('1/q/') for k in got)
    assert np.isfinite(got['items0']).all()
    assert sum(k.startswith('g/') for k in got) == (
        3 * 11 if scheme == 'tpsq' else 0)
    for k, w in single.items():
        np.testing.assert_allclose(got[k], w, **_tol(k), err_msg=k)
    _close_to_jax(got, jx, scheme)
    if scheme == 'wbin':
        assert np.isnan(got['0/p/0/w']).all()
    else:
        assert all(np.isfinite(v).all() for v in got.values())


def test_remat_qat_step_under_tp(job):
    """google with ``remat='blocks'`` (the whole quant apply recomputed in
    the backward, its collectives again in the same order): both ranks
    equal, and bit-equal to the same step without remat."""
    res = job[1]()
    keys = ranks_equal(res, 'remat/')
    assert 'remat/items0' in keys and 'remat/items1' not in keys
    for k in keys:
        np.testing.assert_array_equal(res[0][k], res[0]['google1/' + k[6:]],
                                      err_msg=k)


def test_tpsq_warmup_under_model_group(job):
    """TPSQ's warmup search on the split params under the model group finds
    one process's scales on the whole params (those of
    ``tpsq_init.npz``), on both ranks."""
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    root, wait_all = job
    res = wait_all()
    keys = ranks_equal(res, 'warmup/')
    want = load_checkpoint(os.path.join(root, 'tpsq_init.npz'))['params']
    assert len(keys) == 3 * 11
    for k in keys:
        layer, f = k.split('/')[1:]
        np.testing.assert_allclose(res[0][k], want[layer][f], rtol=1e-6,
                                   err_msg=k)


def test_tiny_qat_step_under_tp(job, references):
    """google on yolov3-tiny at 64 px, global bs 8: one QAT step under tp
    2 against one process, and against JAX's 2-way model mesh by
    ``TINY_JAX_TOL`` (module docstring)."""
    res = job[1]()
    keys = ranks_equal(res, 'tiny/')
    got = {k[5:]: res[0][k] for k in keys}
    single, jx = references['tiny']
    assert got.keys() == single.keys()
    for k, w in single.items():
        np.testing.assert_allclose(got[k], w, **_tol(k), err_msg=k)
    np.testing.assert_allclose(got['items0'], jx['items0'],
                               rtol=TINY_JAX_TOL['items'])
    leaves = [k for k in jx if k != 'items0']
    assert len(leaves) > 100
    sq = lambda a: np.sum(np.square(a, dtype=np.float64))
    d = np.sqrt(sum(sq(got[k] - jx[k]) for k in leaves)
                / sum(sq(jx[k]) for k in leaves))
    assert d <= TINY_JAX_TOL['norm'], d


def test_tp_qat_checkpoint_loads_in_one_process_and_jax(job):
    """The google run's checkpoint under TP holds whole tensors and
    ``qstate``: the port's ``load_model`` and JAX's load them, equal to
    the gathered params and the ranks' ``qstate``."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu import runtime as jrt
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.convert import from_jax, qstate_to_jax
    root, wait_all = job
    res = wait_all()
    path = os.path.join(root, 'tpq.npz')
    cfg = os.path.join(root, 'plain.cfg')
    b = trt.load_model(cfg, path, device='cpu', dtype=torch.float32,
                       prefer_ema=False, quantized=1, steps=QSTEPS)
    jb = jrt.load_model(cfg, path, compute_dtype=jnp.float32,
                        prefer_ema=False, quantized=1, steps=QSTEPS)
    jp, _ = from_jax(b.net, jax.device_get(jb.params), {})
    n = 0
    for k, d in b.params.items():
        for f, t in d.items():
            np.testing.assert_array_equal(t.numpy(),
                                          res[0][f'google/1/p/{k}/{f}'])
            np.testing.assert_array_equal(jp[k][f].numpy(), t.numpy())
            n += 1
    assert n > 20
    want = {k: v for k, v in res[0].items() if k.startswith('google/1/q/')}
    for tree in (qstate_to_jax(b.qstate), jax.device_get(jb.qstate)):
        got = flat(tree, 'google/1/q')
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_quantized_evaluate_under_tp(job):
    """``evaluate(mesh=...)`` at tp 2 from the TP checkpoint's EMA pair:
    both ranks' results equal; the google sim on split params against one
    process on the whole (``test_torch_tp.py``'s tolerances), the int8
    engine, whole on each rank, equal to one process's."""
    root, wait_all = job
    res = wait_all()
    ranks_equal(res, 'eval/')
    single = port_eval(root, os.path.join(root, 'tpq.npz'))
    got = res[0]['eval/sim/res']
    assert got[2] > 0
    np.testing.assert_allclose(got[:4], single['sim/res'][:4], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got[4:], single['sim/res'][4:], rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(res[0]['eval/sim/maps'], single['sim/maps'],
                               rtol=1e-6, atol=1e-9)
    assert res[0]['eval/engine/res'][2] > 0
    for k in ('res', 'maps'):
        np.testing.assert_array_equal(res[0][f'eval/engine/{k}'],
                                      single[f'engine/{k}'])


def test_engine_plan_of_blocks_refused(tmp_path):
    """The int8 engine under a model axis runs whole on every rank: a plan
    built from a rank's blocks raises ValueError before any batch."""
    from yolo_tpu_torch.eval.evaluator import _check_whole_plan
    from yolo_tpu_torch.ir import build_ir
    cfg = tmp_path / 'plain.cfg'
    cfg.write_text(PLAIN_CFG)
    net = build_ir(str(cfg))
    conv = next(l for l in net.layers if l.kind == 'conv' and l.bn)
    plan = lambda n: {str(conv.index): {'w8': torch.zeros(n, 1, 1, 1)}}
    _check_whole_plan(net, plan(conv.filters))
    with pytest.raises(ValueError, match='whole'):
        _check_whole_plan(net, plan(conv.filters // 2))


def test_train_cli_tp_quantized(job, tmp_path, monkeypatch):
    """``python -m yolo_tpu_torch.train --coordinator ... --tp 2
    --quantized 1`` on two ranks: the same loss lines on both, and the
    epoch's sim ``evaluate`` over the model axis; ``results.txt`` and the
    checkpoint, whole and with ``qstate``, from rank 0 alone; its row
    against one process's (``--no-mesh``, the same batches) by
    ``test_torch_parallel.py``'s CLI tolerance."""
    import re
    from yolo_tpu_torch.train.__main__ import main
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    root, wait_all = job
    outs = wait_all.cli()
    lines = [re.findall(r'total (\S+)', o) for o in outs]
    assert len(lines[0]) == 2 and lines[0] == lines[1], outs[0][-3000:]
    rows = np.loadtxt(os.path.join(root, 'cli0', 'results.txt'), ndmin=2)
    assert rows.shape == (1, 12) and np.isfinite(rows).all()
    ck = load_checkpoint(os.path.join(root, 'cli0', 'weights', 'last.npz'))
    assert ck['qstate'] and ck['params']['0']['w'].shape[-1] == 8
    for f in ('results.txt', 'weights/last.npz'):
        assert not os.path.exists(os.path.join(root, 'cli1', f)), f
    monkeypatch.chdir(tmp_path)
    main(cli_args(root) + ['--no-mesh'])
    ref = np.loadtxt(tmp_path / 'results.txt', ndmin=2)
    np.testing.assert_allclose(rows[:, 1:], ref[:, 1:], **CLI_TOL)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--worker']:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
