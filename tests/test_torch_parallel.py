"""The port's data parallelism (``yolo_tpu_torch/parallel/`` and the hooks
that use it) against the JAX package's, on the CPU.

The ranks are processes of a ``torch.distributed`` job over gloo, started
from this file (``python tests/test_torch_parallel.py --worker ...``, which
imports no jax), two to a job, on a free port. One job runs every step and
evaluation scenario once and writes each rank's results to an ``.npz``;
another runs ``python -m yolo_tpu_torch.train --coordinator``. While they
run, this process computes the references: the port in one process on the
global batch, and JAX on a 2-device mesh of its 8 virtual CPU devices (a
one-process mesh over which XLA reduces every batch-wide quantity, what
the port's collectives do across processes).

- ``batch_norm_train`` over the global batch: f32 (two-pass) within 1e-6,
  bf16 (one-pass) within the rounding of y to bf16.
- One f32 ``grad_fn`` + ``update_fn`` step of ``TOY_CFG`` (SGD), bs 8 as
  2 x 4, and the same with a google and a cos-PTQ QAT apply before the
  freeze (on ``PLAIN_CFG``, where the QAT train forward agrees with
  JAX's: see ``test_torch_quant_schemes.py``) and with the KD5 term of a
  teacher of another seed: the loss items within rtol 2e-4 / atol 2e-5, the params,
  BN state and EMA within rtol 1e-3 / atol 1e-4 (JAX's own DP against TP
  tolerance, ``tests/test_parallel.py``), both ranks bit-equal.
- ``evaluate(mesh=...)`` of 9 JPEG files over 2 ranks (rank 1 holds a
  pad): the results within rtol 1e-6 (the val losses 1e-5, summed in
  another order) of one process and the maps equal, as JAX's
  ``tests/test_multihost.py`` holds its own; against JAX's evaluate by
  ``test_torch_eval.py``'s tolerance.
- The device augmentation of the all-gathered global batch, each rank's
  rows equal to one process's.
- The train CLI across 2 processes, 2 epochs of bs 8 on 16 JPEG files,
  against one process fed the same global batches (the two ranks' shard
  loaders, concatenated), and JAX's ``run_training`` on a 2-device mesh fed
  likewise: the epoch losses within rtol 2e-2 / atol 2e-3
  (``tests/test_parallel.py``'s), the same loss lines on both ranks, and
  only rank 0 writing ``results.txt`` and checkpoints.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, images, jax_native, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(scope='module', autouse=True)
def _jax_native_loaded():
    """JAX's ``BatchLoader`` takes its native path where ``yolo_tpu.native``
    loads: load it whichever test process built it
    (``_torch_port.jax_native``)."""
    jax_native()

# TOY_CFG with leaky in place of mish and no weighted shortcut
# (test_torch_quant_schemes.PLAIN_CFG, whose QAT train forward is JAX's)
PLAIN_CFG = TOY_CFG.replace('activation=mish', 'activation=leaky').replace(
    'weights_type=per_feature\n', '')
NC, BS, RANKS, SIZE = 2, 8, 2, 64
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
CLI_TOL = dict(rtol=2e-2, atol=2e-3)
STEPS = ('float', 'qat', 'qat_cos', 'kd')
TIMEOUT = 300
SCHEMES = {'qat': 'google', 'qat_cos': 'ptq_cos'}


def free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn(argv_of_rank, cwd_of_rank, n=RANKS):
    """Start the ``n`` ranks of one job; returns the Popen objects."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(GLOO_SOCKET_IFNAME='lo', OMP_NUM_THREADS='1',
               PYTHONPATH=ROOT)
    return [subprocess.Popen(argv_of_rank(r), cwd=cwd_of_rank(r), env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def wait(procs):
    """Every rank's output; each must exit 0."""
    outs = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} exited {p.returncode}:\n' \
            + out[-4000:]
    return outs


# ------------------------------------------------------------ the inputs

def write_set(root):
    """(cfg paths, 9-image eval .data, 16-image train .data, init .npz)."""
    from test_torch_augment import write_jpeg_set
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    os.makedirs(root, exist_ok=True)
    cfgs = {}
    for name, text in (('toy', TOY_CFG), ('plain', PLAIN_CFG)):
        cfgs[name] = os.path.join(root, f'{name}.cfg')
        with open(cfgs[name], 'w') as f:
            f.write(text)
    with open(os.path.join(root, 'names'), 'w') as f:
        f.write('a\nb\n')
    datas = {}
    for name, n in (('eval', 9), ('train', 16)):
        lst = write_jpeg_set(os.path.join(root, name), n=n, nc=NC,
                             seed=5 + n)
        datas[name] = os.path.join(root, f'{name}.data')
        with open(datas[name], 'w') as f:
            f.write(f'classes={NC}\ntrain={lst}\nvalid={lst}\n'
                    f'names={root}/names\n')
    init = os.path.join(root, 'init.npz')
    pj, sj = random_jax_weights(build_ir(cfgs['toy']), seed=3,
                                conv_scale=0.7)
    save_checkpoint(init, params=pj, state=sj)
    return cfgs, datas, init


def global_batch(seed=11, cap=16, n=12):
    """(x (BS, SIZE, SIZE, 3) f32, targets (cap, 6), valid (cap,)) numpy:
    ``n`` boxes over the BS images, two sharing a cell."""
    rng = np.random.default_rng(seed)
    t = np.zeros((cap, 6), np.float32)
    t[:n, 0] = rng.integers(0, BS, n)
    t[:n, 1] = rng.integers(0, NC, n)
    t[:n, 2:4] = rng.uniform(0.1, 0.9, (n, 2))
    t[:n, 4:6] = rng.uniform(0.1, 0.6, (n, 2))
    t[1, :4], t[1, 4:6] = t[0, :4], t[0, 4:6] * 0.8
    valid = np.arange(cap) < n
    x = images(seed, BS, SIZE).astype(np.float32) / 256.0
    return x, t, valid


def block(x, tgt, valid, rank, cap=16):
    """Rank ``rank``'s block of a global batch: its images, and its
    targets with local image indices, padded to ``cap``."""
    lbs = len(x) // RANKS
    mine = valid & (tgt[:, 0] >= rank * lbs) & (tgt[:, 0] < (rank + 1) * lbs)
    t = np.zeros((cap, 6), np.float32)
    t[:mine.sum()] = tgt[mine]
    t[:mine.sum(), 0] -= rank * lbs
    return x[rank * lbs:(rank + 1) * lbs], t, np.arange(cap) < mine.sum()


def flat(tree, prefix):
    """{prefix/key/...: numpy} of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f'{prefix}/{k}').items()}
    return {prefix: np.array(tree)}


def hyp():
    from yolo_tpu_torch.config import DEFAULT_HYP
    return dict(DEFAULT_HYP)


def anchor_vecs(net):
    return [np.asarray(l.anchors) / l.yolo_stride
            for l in net.layers if l.kind == 'yolo']


# ------------------------------------------------------------ the port's step

def port_step(kind, cfgs, x, tgt, valid, mesh=None):
    """One f32 ``grad_fn`` + ``update_fn`` of ``kind`` ('float', 'qat'
    google, 'qat_cos' cos-PTQ, 'kd') on this rank's block (the whole batch without ``mesh``): the
    global batch's loss items, and the params, BN state, EMA and quantizer
    state, flat (whole tensors under a model axis)."""
    from yolo_tpu_torch.compress import quant as TQ
    from yolo_tpu_torch.convert import from_jax, qstate_to_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.models.network import Darknet
    from yolo_tpu_torch.parallel import gather_state, shard_state
    from yolo_tpu_torch.parallel.collectives import all_reduce_nograd
    from yolo_tpu_torch.train.kd import make_kd_loss_fn
    from yolo_tpu_torch.train.loss import LossHyp
    from yolo_tpu_torch.train.schedules import burn_in_scalars
    from yolo_tpu_torch.train.trainer import (init_train_state,
                                              make_train_functions)
    net = build_ir(cfgs['toy' if kind in ('float', 'kd') else 'plain'])
    pj, sj = random_jax_weights(net, seed=9, conv_scale=0.7)
    avecs = anchor_vecs(net)
    kw, qstate = {}, None
    if kind.startswith('qat'):
        qcfg = TQ.QuantConfig(scheme=SCHEMES[kind], steps=10)
        qstate = TQ.init_quant_state(net, qcfg)[0]
        kw['quant_apply'] = TQ.make_quant_apply(net, qcfg,
                                                head_layout='nhwc')
    elif kind == 'kd':
        tpj, tsj = random_jax_weights(net, seed=21, conv_scale=0.7)
        teacher = Darknet(net, *from_jax(net, tpj, tsj), dtype=None)
        kw['kd_loss_fn'] = make_kd_loss_fn(
            5, teacher, NC, avecs, img_size=SIZE,
            strides=[l.yolo_stride for l in net.layers if l.kind == 'yolo'],
            kd5_mask='diag', layout='nhwc')
    grad_fn, update_fn = make_train_functions(
        net, avecs, NC, LossHyp.from_dict(hyp(), nc=NC), mesh=mesh, **kw)
    ts = init_train_state(net, *from_jax(net, pj, sj), compute_dtype=None,
                          device='cpu', qstate=qstate)
    if mesh is not None:
        shard_state(mesh, net, ts)
    sc, gr, _ = burn_in_scalars(1000, 500, 0, lr0=0.01, momentum=0.937,
                                weight_decay=5e-4, epochs=10, batch_size=BS)
    ts, items = grad_fn(ts, torch.from_numpy(x), torch.from_numpy(tgt),
                        torch.from_numpy(valid), gr, BS / 64.0)
    ts = update_fn(ts, sc)
    out = {'items': all_reduce_nograd(
        items, None if mesh is None else mesh.data_group).numpy()}
    whole = lambda tree: gather_state(mesh, net, tree)
    for tag, tree in (('p', whole(ts.params)), ('s', whole(ts.bn_state)),
                      ('ep', whole(ts.ema.params)),
                      ('es', whole(ts.ema.state))):
        for k, d in tree.items():
            for f, t in d.items():
                out[f'{tag}/{k}/{f}'] = t.detach().numpy().copy()
    if ts.qstate is not None:
        out.update(flat(qstate_to_jax(ts.qstate), 'q'))
    return out


def port_bn(dtype, x, w, rank=None, mesh=None):
    """``batch_norm_train`` of an NCHW batch (this rank's block under
    ``mesh``) and the gradients of sum(y * w): y, the running stats, and
    the x, gamma and beta gradients (the latter two summed over ranks)."""
    from yolo_tpu_torch.ops.conv import batch_norm_train
    from yolo_tpu_torch.parallel.collectives import all_reduce_nograd
    c = x.shape[1]
    rng = np.random.default_rng(7)
    gamma = torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32,
                         requires_grad=True)
    beta = torch.tensor(rng.normal(0, 0.1, c), dtype=torch.float32,
                        requires_grad=True)
    rm = torch.tensor(rng.normal(0, 0.3, c), dtype=torch.float32)
    rv = torch.tensor(rng.uniform(0.5, 2, c), dtype=torch.float32)
    if mesh is not None:
        lb = len(x) // RANKS
        x, w = x[rank * lb:(rank + 1) * lb], w[rank * lb:(rank + 1) * lb]
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    group = None if mesh is None else mesh.data_group
    y, m, v = batch_norm_train(xt, gamma, beta, rm, rv, group=group)
    (y.float() * torch.from_numpy(w)).sum().backward()
    return {'y': y.float().detach().numpy(), 'mean': m.numpy(),
            'var': v.numpy(), 'gx': xt.grad.float().numpy(),
            'ggamma': all_reduce_nograd(gamma.grad, group).numpy(),
            'gbeta': all_reduce_nograd(beta.grad, group).numpy()}


def bn_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(1.5, 2.0, (BS, 6, 5, 5)).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    return x, w


def port_eval(cfgs, datas, mesh=None):
    """evaluate of the 9-file set in f32 with val losses, bs 2: over the
    mesh (its weights laid out by ``shard_state``), or in one process on
    square letterboxes."""
    from yolo_tpu_torch import runtime as trt
    from yolo_tpu_torch.config import parse_data_cfg
    from yolo_tpu_torch.data.datasets import DetectionDataset
    from yolo_tpu_torch.eval.evaluator import evaluate
    from yolo_tpu_torch.parallel import shard_state
    from yolo_tpu_torch.train.loss import LossHyp
    b = trt.load_model(cfgs['toy'], os.path.join(
        os.path.dirname(cfgs['toy']), 'init.npz'), device='cpu',
        dtype=torch.float32)
    if mesh is not None:
        shard_state(mesh, b.net, b.params)
        shard_state(mesh, b.net, b.state)
    ds = None
    if mesh is None:
        ds = DetectionDataset(parse_data_cfg(datas['eval'])['valid'], SIZE,
                              2, rect=False)
    res, maps, _ = evaluate(b.net, b.params, b.state, datas['eval'],
                            batch_size=2, img_size=SIZE,
                            compute_dtype=torch.float32, dataset=ds,
                            loss_hyp=LossHyp.from_dict(hyp(), nc=NC),
                            anchor_vecs=anchor_vecs(b.net), mesh=mesh,
                            plot=mesh is not None, device='cpu')
    return {'res': np.asarray(res, np.float64), 'maps': np.asarray(maps)}


def port_aug(rank=None, mesh=None):
    """The device augmentation of the global batch (all-gathered from the
    ranks' uint8 blocks under ``mesh``), each rank's rows."""
    from yolo_tpu_torch.data.device_aug import make_device_augment, rows_of
    from yolo_tpu_torch.parallel import allgather_host_values
    from yolo_tpu_torch.runtime import preprocess
    u8 = images(31, BS, SIZE)
    x, tgt, valid = global_batch(seed=31)
    aug = make_device_augment(SIZE, dict(hyp(), degrees=5.0, translate=0.1,
                                         scale=0.2, shear=2.0))
    out = {}
    for r in range(RANKS) if mesh is None else (rank,):
        if mesh is not None:
            lu8, lt, lv = block(u8, tgt, valid, r)
            lt[:, 0] += r * (BS // RANKS)
            u8g = allgather_host_values(lu8).reshape(u8.shape)
            tg = allgather_host_values(lt).reshape(-1, 6)
            vg = allgather_host_values(lv).reshape(-1)
        else:
            # the all-gathered layout: each rank's padded block in turn
            parts = [block(u8, tgt, valid, q) for q in range(RANKS)]
            for q, p in enumerate(parts):
                p[1][:, 0] += q * (BS // RANKS)
            u8g = u8
            tg = np.concatenate([p[1] for p in parts])
            vg = np.concatenate([p[2] for p in parts])
        g = torch.Generator().manual_seed(17)
        xa, ta, va = aug(preprocess(u8g, device='cpu'), torch.from_numpy(tg),
                         torch.from_numpy(vg), g)
        xr, tr, vr = rows_of(xa, ta, va, r * (BS // RANKS), BS // RANKS)
        out.update({f'x{r}': xr.numpy(), f't{r}': tr[vr].numpy()})
    return out


def quant_inputs():
    """An activation whose two halves (the ranks' blocks) have ranges far
    apart: each half alone picks another cos-PTQ scale and tracks another
    range than the whole."""
    rng = np.random.default_rng(13)
    return np.concatenate([rng.normal(0, 0.05, (BS // 2, 4, 4, 8)),
                           rng.normal(0, 20.0, (BS // 2, 4, 4, 8))]
                          ).astype(np.float32)


def port_quant_stats(x, rank=None, mesh=None):
    """The cos-PTQ votes and scale and the google tracker's range after
    one train-mode call on ``x`` (this rank's block under ``mesh``)."""
    from yolo_tpu_torch.compress import quant as TQ
    group = None
    if mesh is not None:
        lb = len(x) // RANKS
        x, group = x[rank * lb:(rank + 1) * lb], mesh.data_group
    xt = torch.from_numpy(x)
    _, cq = TQ.cospt_quantize(xt, TQ.cospt_init(8), bits=8, train=True,
                              group=group)
    _, gq = TQ.google_quantize(xt, TQ.tracker_init(), bits=8, train=True,
                               freeze_step=10, group=group)
    return {'votes': cq['votes'].numpy(), 'scale': cq['scale'].numpy(),
            'min': gq['min'].numpy(), 'max': gq['max'].numpy()}


def worker(rank, port, root):
    """One rank of the scenario job: every scenario, into
    ``root/rank{rank}.npz``."""
    from yolo_tpu_torch.parallel import init_multihost, make_mesh
    torch.set_num_threads(1)
    dev = init_multihost(f'localhost:{port}', RANKS, rank, device='cpu')
    mesh = make_mesh(dev)
    cfgs, datas = {k: os.path.join(root, f'{k}.cfg')
                   for k in ('toy', 'plain')}, \
        {k: os.path.join(root, f'{k}.data') for k in ('eval', 'train')}
    out = {}
    x, w = bn_inputs()
    for dt, dtype in (('f32', torch.float32), ('bf16', torch.bfloat16)):
        out.update({f'bn_{dt}/{k}': v for k, v in
                    port_bn(dtype, x, w, rank, mesh).items()})
    out.update({f'quant/{k}': v for k, v in
                port_quant_stats(quant_inputs(), rank, mesh).items()})
    xb, tb, vb = global_batch()
    for kind in STEPS:
        out.update({f'{kind}/{k}': v for k, v in port_step(
            kind, cfgs, *block(xb, tb, vb, rank), mesh=mesh).items()})
    os.chdir(os.path.join(root, f'rank{rank}'))
    out.update({f'eval/{k}': v for k, v in
                port_eval(cfgs, datas, mesh).items()})
    out.update({f'aug/{k}': v for k, v in port_aug(rank, mesh).items()})
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(root, f'rank{rank}.npz'), **out)


# ------------------------------------------------------------ the jobs

@pytest.fixture(scope='module')
def job(tmp_path_factory):
    """Start both jobs (scenarios and the train CLI); yields (root, cfgs,
    datas, init, wait) where wait() returns (scenario results by rank,
    CLI outputs by rank)."""
    root = str(tmp_path_factory.mktemp('parallel'))
    cfgs, datas, init = write_set(root)
    for r in range(RANKS):
        os.makedirs(os.path.join(root, f'rank{r}'))
        os.makedirs(os.path.join(root, f'cli{r}'))
    port = free_port()
    scen = spawn(lambda r: [sys.executable, os.path.abspath(__file__),
                            '--worker', str(r), str(port), root],
                 lambda r: root)
    port2 = free_port()
    cli = spawn(lambda r: [sys.executable, '-m', 'yolo_tpu_torch.train',
                           '--coordinator', f'localhost:{port2}',
                           '--num-hosts', str(RANKS), '--host-id', str(r),
                           '--device', 'cpu'] + cli_args(cfgs, datas, init),
                lambda r: os.path.join(root, f'cli{r}'))
    done = {}

    def wait_all():
        if not done:
            outs = wait(scen)
            done['scen'] = [dict(np.load(os.path.join(root, f'rank{r}.npz')))
                            for r in range(RANKS)]
            done['scen_out'] = outs
            done['cli'] = wait(cli)
        return done
    try:
        yield root, cfgs, datas, init, wait_all
    finally:
        for p in scen + cli:
            if p.poll() is None:
                p.kill()
                p.communicate()


def cli_args(cfgs, datas, init):
    return ['--cfg', cfgs['toy'], '--data', datas['train'], '--weights',
            init, '--epochs', '2', '--batch-size', str(BS), '--img-size',
            str(SIZE)]


def ranks_equal(res, prefix):
    keys = [k for k in res[0] if k.startswith(prefix)]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
    return keys


# ------------------------------------------------------------ host shards

@pytest.mark.parametrize('n', [7, 8, 9, 13])
@pytest.mark.parametrize('pc', [2, 3])
def test_process_shard_matches_jax(n, pc, tmp_path):
    """``DetectionDataset(process_shard=...)``: the files, the pad mask
    through ``path_of`` and the shard's length, with and without
    ``subset_len``, equal to JAX's on the same list; shards of equal
    length that cover the list."""
    from yolo_tpu.data.datasets import DetectionDataset as JDS
    from yolo_tpu_torch.data.datasets import DetectionDataset as TDS
    lst = tmp_path / 'l.txt'
    lst.write_text('\n'.join(str(tmp_path / f'im{i}.jpg') for i in range(n)))
    seen = set()
    for pi in range(pc):
        for sub in (-1, 2):
            kw = dict(process_shard=(pi, pc), subset_len=sub, seed=4)
            t, j = TDS(str(lst), 64, 2, **kw), JDS(str(lst), 64, 2, **kw)
            assert t.img_files == j.img_files and t.n == j.n
            assert [t.path_of(i) for i in range(t.n)] == \
                [j.path_of(i) for i in range(j.n)]
            if sub == -1:
                assert t.n == -(-n // pc)
                seen |= {t.path_of(i) for i in range(t.n)} - {''}
    assert len(seen) == n


def test_host_shard_matches_jax():
    from yolo_tpu.parallel import host_shard as jshard
    from yolo_tpu_torch.parallel import host_shard
    items = list(range(23))
    for pc in (1, 2, 4):
        for pi in range(pc):
            assert host_shard(items, process_index=pi, process_count=pc) \
                == jshard(items, process_index=pi, process_count=pc)
    assert host_shard(items) == items      # one process outside a job


def test_mesh_outside_a_job():
    """One process: a mesh of one rank that communicates nothing;
    ``shard_batch`` takes every row, ``replicate`` and ``shard_state``
    leave values alone, ``shard_spatial`` returns its input (the whole
    image is this rank's rows), and a model axis, which needs ranks,
    raises ValueError as JAX's assertion does."""
    from yolo_tpu_torch.parallel import (DATA_AXIS, make_mesh, replicate,
                                         shard_batch, shard_spatial,
                                         shard_state, state_shardings)
    mesh = make_mesh('cpu')
    assert mesh.shape[DATA_AXIS] == 1 and mesh.data_group is None
    assert mesh.model_group is None and mesh.model_index == 0
    a = np.arange(8)
    assert np.array_equal(shard_batch(mesh, a), a)
    t = {'0': {'w': torch.ones(3)}}
    assert replicate(mesh, t) is t and shard_state(mesh, None, t) is t
    assert state_shardings(mesh, None, t)['0']['w'].spec == ()
    x = torch.rand(1, 8, 8, 3)
    assert shard_spatial(mesh, x) is x
    with pytest.raises(ValueError, match='model_parallel=2'):
        make_mesh('cpu', model_parallel=2)


@pytest.mark.parametrize('argv', [['--tp', '2', '--quantized', '1'],
                                  ['--remat', 'blocks']],
                         ids=['tp', 'remat'])
def test_cli_unported_parallel_flags_raise(argv, monkeypatch):
    """Beside ``--coordinator``: ``--tp`` with ``--quantized`` (QAT under
    tensor parallelism) and ``--remat``, which once raised, join the job
    (the join stubbed here) and reach ``run_training`` with their
    options."""
    from yolo_tpu_torch import parallel
    from yolo_tpu_torch.train import loop
    from yolo_tpu_torch.train.__main__ import main
    joined, opts = [], []
    monkeypatch.setattr(parallel, 'init_multihost', lambda *a, **k:
                        joined.append((a, k)) or torch.device('cpu'))
    monkeypatch.setattr(torch.distributed, 'destroy_process_group',
                        lambda: None)
    monkeypatch.setattr(loop, 'run_training', lambda o: opts.append(o)
                        or (0.0,) * 7)
    argv = argv + ['--coordinator', 'localhost:1', '--num-hosts', '2',
                   '--host-id', '0', '--device', 'cpu']
    main(argv)
    assert joined[0][0] == ('localhost:1',)
    assert joined[0][1]['num_processes'] == 2
    assert opts[0].device == 'cpu'
    if '--quantized' in argv:
        assert (opts[0].tp, opts[0].quantized) == (2, 1)
    else:
        assert opts[0].remat == 'blocks'


# ------------------------------------------------------------ the job's ranks

@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_batch_norm_over_ranks(dt, job):
    """Each rank's y and x-gradient are the rows of one process's on the
    global batch, the running statistics and the gamma/beta gradients its
    values, both ranks' statistics equal. f32 within 1e-6; bf16 (one-pass)
    within two bf16 ulps of y (its statistics in f32 within 1e-5)."""
    res = job[4]()['scen']
    x, w = bn_inputs()
    dtype = torch.float32 if dt == 'f32' else torch.bfloat16
    ref = port_bn(dtype, x, w)
    ranks_equal(res, f'bn_{dt}/mean')
    ranks_equal(res, f'bn_{dt}/ggamma')
    tol = dict(rtol=1e-6, atol=1e-6) if dt == 'f32' \
        else dict(rtol=2 ** -7, atol=2 ** -7)
    stat = dict(rtol=1e-6, atol=1e-6) if dt == 'f32' \
        else dict(rtol=1e-5, atol=1e-5)
    for k in ('mean', 'var', 'ggamma', 'gbeta'):
        np.testing.assert_allclose(res[0][f'bn_{dt}/{k}'], ref[k],
                                   **stat, err_msg=k)
    for k in ('y', 'gx'):
        got = np.concatenate([res[r][f'bn_{dt}/{k}'] for r in range(RANKS)])
        np.testing.assert_allclose(got, ref[k], **tol, err_msg=k)


def test_quantizer_statistics_over_ranks(job):
    """The cos-PTQ vote and the google tracker's range of blocks whose
    ranges differ: on both ranks those of one process on the whole batch,
    which neither block alone gives."""
    res = job[4]()['scen']
    ranks_equal(res, 'quant/')
    x = quant_inputs()
    ref = port_quant_stats(x)
    for k, v in ref.items():
        np.testing.assert_array_equal(res[0][f'quant/{k}'], v, err_msg=k)
    half = port_quant_stats(x[:BS // 2])
    assert not np.array_equal(half['votes'], ref['votes'])
    assert half['max'] != ref['max']


def jax_step(kind, cfgs, x, tgt, valid):
    """JAX's f32 step of ``kind`` on a 2-device mesh: loss items and the
    flat params, BN state and EMA (the port's keys and layout)."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.compress import quant as JQ
    from yolo_tpu.ir import build_ir
    from yolo_tpu.models.network import make_apply
    from yolo_tpu.parallel import make_mesh, shard_batch, shard_state
    from yolo_tpu.train import kd as JK
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu.train.schedules import burn_in_scalars
    from yolo_tpu.train.trainer import init_train_state, make_train_functions
    from yolo_tpu_torch.convert import from_jax
    net = build_ir(cfgs['toy' if kind in ('float', 'kd') else 'plain'])
    pj, sj = random_jax_weights(net, seed=9, conv_scale=0.7)
    avecs = anchor_vecs(net)
    kw, jq = {}, None
    if kind.startswith('qat'):
        qcfg = JQ.QuantConfig(scheme=SCHEMES[kind], steps=10)
        jq = JQ.init_quant_state(net, qcfg)[0]
        kw['quant_apply'] = JQ.make_quant_apply(
            net, qcfg, compute_dtype=jnp.float32, head_layout='nhwc')
    elif kind == 'kd':
        tpj, tsj = random_jax_weights(net, seed=21, conv_scale=0.7)
        kw['kd_loss_fn'] = JK.make_kd_loss_fn(
            5, make_apply(net, compute_dtype=None, head_layout='nhwc'),
            jax.tree.map(jnp.asarray, tpj), jax.tree.map(jnp.asarray, tsj),
            NC, avecs, img_size=SIZE,
            strides=[l.yolo_stride for l in net.layers if l.kind == 'yolo'],
            kd5_mask='diag', layout='nhwc')
    grad_fn, update_fn = make_train_functions(
        net, avecs, NC, JHyp.from_dict(hyp(), nc=NC), compute_dtype=None,
        **kw)
    ts = init_train_state(jax.tree.map(jnp.asarray, pj),
                          jax.tree.map(jnp.asarray, sj), qstate=jq)
    sc, gr, _ = burn_in_scalars(1000, 500, 0, lr0=0.01, momentum=0.937,
                                weight_decay=5e-4, epochs=10, batch_size=BS)
    mesh = make_mesh(jax.devices()[:RANKS])
    with mesh:
        ts = shard_state(mesh, net, ts)
        ts, items = grad_fn(ts, shard_batch(mesh, jnp.asarray(x)),
                            jnp.asarray(tgt), jnp.asarray(valid), gr,
                            BS / 64.0)
        ts = update_fn(ts, sc)
    ts = jax.device_get(ts)
    out = {'items': np.asarray(items)}
    for tag, (p, s) in (('', (ts.params, ts.bn_state)),
                        ('e', (ts.ema.params, ts.ema.state))):
        tp, tsd = from_jax(net, p, s)
        for k, d in tp.items():
            for f, t in d.items():
                out[f'{tag}p/{k}/{f}'] = t.numpy()
        for k, d in tsd.items():
            for f, t in d.items():
                out[f'{tag}s/{k}/{f}'] = t.numpy()
    if ts.qstate is not None:
        out.update(flat(ts.qstate, 'q'))
    return out


@pytest.fixture(scope='module')
def references(job):
    """The port's one-process step and JAX's 2-device mesh step of each
    kind on the global batch (computed while the job runs)."""
    import jax
    cfgs = job[1]
    prec = jax.config.jax_default_matmul_precision
    jax.config.update('jax_default_matmul_precision', 'highest')
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        xb, tb, vb = global_batch()
        return {kind: (port_step(kind, cfgs, xb, tb, vb),
                       jax_step(kind, cfgs, xb, tb, vb)) for kind in STEPS}
    finally:
        jax.config.update('jax_default_matmul_precision', prec)
        torch.set_num_threads(threads)


@pytest.mark.parametrize('kind', STEPS)
def test_step_over_ranks(kind, job, references):
    """Both ranks end bit-equal; the loss items, params, BN state, EMA and
    (QAT) the quantizer state (the global batch's tracker ranges) match
    one process on the global batch and JAX's 2-device mesh step."""
    res = job[4]()['scen']
    keys = ranks_equal(res, f'{kind}/')
    single, jx = references[kind]
    got = {k[len(kind) + 1:]: res[0][k] for k in keys}
    assert got.keys() == single.keys()
    assert {'items'} | {k for k in jx if k != 'items'} == set(got)
    for ref in (single, jx):
        np.testing.assert_allclose(got['items'], ref['items'], **LOSS_TOL)
        for k in got:
            if k != 'items':
                np.testing.assert_allclose(got[k], ref[k], **PARAM_TOL,
                                           err_msg=k)


def test_evaluate_over_ranks(job):
    """Both ranks' results equal each other; against one process within
    rtol 1e-6 (val losses 1e-5) with the maps equal, and against JAX's
    evaluate by ``test_torch_eval.py``'s tolerance. Rank 0 alone plots."""
    from yolo_tpu.data.datasets import DetectionDataset as JDS
    from yolo_tpu.eval.evaluator import evaluate as jeval
    from yolo_tpu.ir import build_ir
    from yolo_tpu.train.loss import LossHyp as JHyp
    from yolo_tpu_torch.config import parse_data_cfg
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    import jax.numpy as jnp
    root, cfgs, datas, init, wait_all = job
    res = wait_all()['scen']
    ranks_equal(res, 'eval/')
    got = res[0]['eval/res']
    single = port_eval(cfgs, datas)
    assert got[2] > 0 and got[4:].min() > 0, got
    np.testing.assert_allclose(got[:4], single['res'][:4], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got[4:], single['res'][4:], rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(res[0]['eval/maps'], single['maps'],
                               rtol=1e-6, atol=1e-9)
    net = build_ir(cfgs['toy'])
    ck = load_checkpoint(init)
    lst = parse_data_cfg(datas['eval'])['valid']
    rj, mj, _ = jeval(net, ck['params'], ck['state'], datas['eval'],
                      batch_size=2, img_size=SIZE,
                      compute_dtype=jnp.float32, dataset=JDS(lst, SIZE, 2),
                      loss_hyp=JHyp.from_dict(hyp(), nc=NC),
                      anchor_vecs=anchor_vecs(net), progress=False)
    np.testing.assert_allclose(got, np.asarray(rj, np.float64), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res[0]['eval/maps'], mj, rtol=1e-4,
                               atol=1e-4)
    for f in ('test_batch0_gt.jpg', 'test_batch0_pred.jpg'):
        assert os.path.exists(os.path.join(root, 'rank0', f))
        assert not os.path.exists(os.path.join(root, 'rank1', f))


def test_device_augment_over_ranks(job):
    """Each rank augments the all-gathered global batch with the same
    draws and keeps its rows: equal to one process's rows."""
    res = job[4]()['scen']
    ref = port_aug()
    for r in range(RANKS):
        for k in (f'x{r}', f't{r}'):
            np.testing.assert_array_equal(res[r][f'aug/{k}'], ref[k])
        assert len(ref[f't{r}'])


# ------------------------------------------------------------ the train CLI

def test_train_cli_over_ranks(job, tmp_path, monkeypatch):
    """``python -m yolo_tpu_torch.train --coordinator --num-hosts 2
    --host-id i``: the same loss lines on both ranks, results.txt and the
    checkpoints on rank 0 alone; its epoch losses against one process
    (``--no-mesh``) and JAX's ``run_training`` on a 2-device mesh, both fed
    the ranks' batches."""
    import jax
    from yolo_tpu.data import datasets as jds
    from yolo_tpu.parallel import make_mesh as jmesh
    from yolo_tpu.train import loop as jloop
    from yolo_tpu_torch.data import datasets as tds
    from yolo_tpu_torch.train import loop as tloop
    from yolo_tpu_torch.train.__main__ import main
    from chip_smoke import paired_loaders
    root, cfgs, datas, init, wait_all = job
    outs = wait_all()['cli']
    lines = [re.findall(r'total (\S+)', o) for o in outs]
    assert lines[0] and lines[0] == lines[1], outs[0][-3000:]
    assert np.isfinite([float(v) for v in lines[0]]).all()
    rows = np.loadtxt(os.path.join(root, 'cli0', 'results.txt'), ndmin=2)
    assert rows.shape == (2, 12) and np.isfinite(rows).all()
    assert os.path.exists(os.path.join(root, 'cli0', 'weights', 'last.npz'))
    for f in ('results.txt', 'weights/last.npz', 'train_batch0.jpg'):
        assert not os.path.exists(os.path.join(root, 'cli1', f)), f

    got = {}
    for name, mod, ds_mod in (('port', tloop, tds), ('jax', jloop, jds)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        ds_cls, loader_cls = paired_loaders(ds_mod.DetectionDataset,
                                            ds_mod.BatchLoader)
        monkeypatch.setattr(mod, 'DetectionDataset', ds_cls)
        monkeypatch.setattr(mod, 'BatchLoader', loader_cls)
        if name == 'port':
            main(cli_args(cfgs, datas, init) + ['--device', 'cpu',
                                                 '--no-mesh'])
        else:
            jloop.run_training(jloop.TrainOptions(
                cfg=cfgs['toy'], data=datas['train'], weights=init,
                epochs=2, batch_size=BS, img_size=(SIZE,) * 3,
                device_mesh=jmesh(jax.devices()[:RANKS])))
        got[name] = np.loadtxt(d / 'results.txt', ndmin=2)
    for name, ref in got.items():
        np.testing.assert_allclose(rows[:, 1:5], ref[:, 1:5], **CLI_TOL,
                                   err_msg=name)


if __name__ == '__main__':
    if sys.argv[1:2] == ['--worker']:
        worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
