"""The port's training loop (``yolo_tpu_torch.train.loop.run_training``
and ``python -m yolo_tpu_torch.train``) against the JAX package's, on the
CPU.

Both loops train ``TOY_CFG`` in f32 from the same seeded .npz on a
synthetic set of 8 JPEG files: 64 px, bs 4, 2 epochs, mosaic / affine /
HSV / flips on, multi-scale 32-64 px, a burn-in of 2 batches and an
optimizer step every 2 batches. Their ``results.txt`` rows agree: the
training losses within rtol 1e-3 (the step agrees to ~1e-5; the
augmented batches are bit-equal), the val losses within rtol 5e-3 and
P, R, mAP@0.5 and F1 within 0.01 (both loops evaluate in bf16, the JAX
package's default, where the CPU convs round differently, and the
near-random model's P/R sit on few detections). Then each resumes its own
``last.npz`` for a third epoch.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import TOY_CFG, random_jax_weights
from test_torch_augment import write_jpeg_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRAIN_COLS = slice(1, 5)     # giou obj cls total (epoch means)
METRIC_COLS = slice(5, 9)    # P R mAP@0.5 F1
VAL_COLS = slice(9, 12)      # val giou obj cls


@pytest.fixture(scope='module')
def train_set(tmp_path_factory):
    """(root, cfg, .data, initial .npz)."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    root = str(tmp_path_factory.mktemp('trainset'))
    lst = write_jpeg_set(root, n=8, nc=2, seed=4)
    cfg = os.path.join(root, 'toy.cfg')
    with open(cfg, 'w') as f:
        f.write(TOY_CFG)
    with open(os.path.join(root, 'names'), 'w') as f:
        f.write('a\nb\n')
    data = os.path.join(root, 'set.data')
    with open(data, 'w') as f:
        f.write(f'classes=2\ntrain={lst}\nvalid={lst}\n'
                f'names={root}/names\n')
    pj, sj = random_jax_weights(build_ir(cfg), seed=3, conv_scale=0.7)
    init = os.path.join(root, 'init.npz')
    save_checkpoint(init, params=pj, state=sj)
    return root, cfg, data, init


def _run(which, workdir, cfg, data, weights, epochs, resume=False):
    """One ``run_training`` of ``which`` ('jax' or 'torch') in
    ``workdir``; returns its results.txt rows."""
    import jax
    import torch
    os.makedirs(workdir, exist_ok=True)
    kw = dict(cfg=cfg, data=data, weights=weights, epochs=epochs,
              batch_size=4, img_size=(32, 64, 64), float_dtype='f32',
              n_burn_override=2, accumulate_override=2, seed=1,
              resume=resume, weights_dir=os.path.join(workdir, 'weights'),
              results_file=os.path.join(workdir, 'results.txt'),
              log_fn=lambda *a: None)
    old = (os.getcwd(), torch.get_num_threads(),
           jax.config.jax_default_matmul_precision)
    os.chdir(workdir)
    torch.set_num_threads(2)
    jax.config.update('jax_default_matmul_precision', 'highest')
    try:
        if which == 'jax':
            from yolo_tpu.train.loop import TrainOptions, run_training
            run_training(TrainOptions(device_mesh=False, **kw))
        else:
            from yolo_tpu_torch.train.loop import TrainOptions, run_training
            run_training(TrainOptions(device='cpu', **kw))
    finally:
        os.chdir(old[0])
        torch.set_num_threads(old[1])
        jax.config.update('jax_default_matmul_precision', old[2])
    return np.loadtxt(os.path.join(workdir, 'results.txt'), ndmin=2)


@pytest.fixture(scope='module')
def runs(train_set):
    root, cfg, data, init = train_set
    return {w: _run(w, os.path.join(root, w), cfg, data, init, 2)
            for w in ('jax', 'torch')}


def _rows_agree(a, b):
    assert a.shape == b.shape and a.shape[1] == 12
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, TRAIN_COLS], b[:, TRAIN_COLS], rtol=1e-3)
    np.testing.assert_allclose(a[:, VAL_COLS], b[:, VAL_COLS], rtol=5e-3)
    np.testing.assert_allclose(a[:, METRIC_COLS], b[:, METRIC_COLS],
                               atol=0.01)


def test_run_training_matches_jax(runs, train_set):
    root = train_set[0]
    _rows_agree(runs['torch'], runs['jax'])
    assert runs['torch'].shape[0] == 2
    # the loss moved, and both wrote the first batch's mosaic
    assert not np.array_equal(runs['torch'][0, TRAIN_COLS],
                              runs['torch'][1, TRAIN_COLS])
    for w in ('jax', 'torch'):
        assert os.path.getsize(os.path.join(root, w, 'train_batch0.jpg')) > 0


def test_last_checkpoint_loads_in_both_packages(runs, train_set):
    """The port's last.npz: JAX's ``load_checkpoint`` reads its params,
    state, EMA pair and counter; the port's ``load_model(prefer_ema=True)``
    serves the EMA pair and ``prefer_ema=False`` the raw one; the final
    epoch's file holds no optimizer state, as JAX's does not."""
    import torch
    from yolo_tpu.utils.checkpoint import load_checkpoint as jload
    from yolo_tpu_torch.runtime import load_model
    root, cfg, _, _ = train_set
    path = os.path.join(root, 'torch', 'weights', 'last.npz')
    ck, jck = jload(path), jload(os.path.join(root, 'jax', 'weights',
                                              'last.npz'))
    assert set(ck) == set(jck)
    assert ck['epoch'] == 1 and 'opt_state' not in ck
    assert ck['ema_updates'] == jck['ema_updates'] == 2   # ni = 0, 2
    assert ck['params'].keys() == jck['params'].keys()
    for k in jck['params']:
        for f, a in jck['params'][k].items():
            assert ck['params'][k][f].shape == a.shape, (k, f)
    for prefer, src in ((True, 'ema'), (False, 'params')):
        b = load_model(cfg, path, device='cpu', dtype=torch.float32,
                       prefer_ema=prefer)
        np.testing.assert_array_equal(
            b.params['0']['w'].numpy(),
            ck[src]['0']['w'].transpose(3, 2, 0, 1))
    assert os.path.exists(os.path.join(root, 'torch', 'weights', 'best.npz'))


def test_resume_third_epoch_matches_jax(runs, train_set):
    """``resume`` from each package's own last.npz for a third epoch: the
    first two rows are carried over and the third agrees."""
    root, cfg, data, _ = train_set
    out = {}
    for w in ('jax', 'torch'):
        wd = os.path.join(root, w)
        out[w] = _run(w, wd, cfg, data, os.path.join(wd, 'weights',
                                                     'last.npz'), 3,
                      resume=True)
        assert out[w].shape[0] == 3
        np.testing.assert_array_equal(out[w][:2], runs[w])
    _rows_agree(out['torch'], out['jax'])


def test_resume_restores_optimizer_and_ema(train_set, tmp_path):
    """A mid-run checkpoint holds the momentum buffers and the EMA with its
    counter, and ``_restore`` puts them back (the JAX package writes its
    optimizer state as a positional list, which the port reads too)."""
    import torch
    from yolo_tpu_torch.convert import from_jax, opt_state_to_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.train.loop import _restore, save_train_checkpoint
    from yolo_tpu_torch.train.trainer import init_train_state
    from yolo_tpu_torch.utils.checkpoint import load_checkpoint
    _, cfg, _, init = train_set
    net = build_ir(cfg)
    ck0 = load_checkpoint(init)
    p, s = from_jax(net, ck0['params'], ck0['state'])
    ts = init_train_state(net, p, s, compute_dtype=None, device='cpu')
    for g in ts.optimizer.param_groups:
        for q in g['params']:
            ts.optimizer.state[q]['momentum_buffer'] = torch.full_like(q, 0.25)
    ts.ema.updates.fill_(7)
    path = str(tmp_path / 'mid.npz')
    save_train_checkpoint(path, ts, net, epoch=0, best_fitness=0.1,
                          results_file=str(tmp_path / 'none.txt'),
                          with_opt=True)
    ck = load_checkpoint(path)
    for layout in ('named', 'jax_list'):
        if layout == 'jax_list':
            ck['opt_state'] = [opt_state_to_jax(
                net, ts.opt_state)['momentum_buf']]
        fresh = init_train_state(net, p, s, compute_dtype=None, device='cpu')
        _restore(fresh, ck, net, print)
        assert int(fresh.ema.updates) == 7
        bufs = fresh.optimizer.state_tree()['momentum_buf']
        assert all(torch.all(t == 0.25) for d in bufs.values()
                   for t in d.values())


def test_cli_runs_on_cpu(train_set, tmp_path):
    """``python -m yolo_tpu_torch.train --device cpu`` in a subprocess."""
    _, cfg, data, init = train_set
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, '-m', 'yolo_tpu_torch.train', '--device', 'cpu',
         '--cfg', cfg, '--data', data, '--weights', init, '--epochs', '1',
         '--batch-size', '4', '--img-size', '64',
         '--prune', '0', '--s', '0.001'],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert (tmp_path / 'results.txt').read_text().count('\n') == 1
    assert (tmp_path / 'weights' / 'last.npz').exists()
    assert 'jax' not in r.stderr


@pytest.mark.parametrize('argv', [
    ['--tp', '2'], ['--remat', 'blocks'],
    ['--coordinator', 'localhost:1234', '--tp', '2', '--quantized', '1'],
    ['--num-hosts', '2', '--tp', '2'], ['--host-id', '1', '--remat', 'full'],
    ['--num_hosts', '4', '--tp', '4', '--quantized', '1']],
    ids=lambda a: a[0].lstrip('-'))
def test_cli_unported_flags_raise(argv, train_set, tmp_path, monkeypatch):
    """--tp and --remat, which once raised, now run: one process with
    ``--tp K`` trains without a mesh (JAX's rule: the model axis needs
    ranks), and ``--remat`` reaches ``make_train_functions``; beside the
    multi-host flags alone (which join no job without ``--coordinator``)
    the same. ``--tp`` with ``--quantized`` (QAT under tensor parallelism,
    which raised until the port's last slice) trains likewise: alone, or
    after joining a job (the join stubbed here, so the process is still
    one rank and trains without a mesh), the quant apply in the step."""
    from yolo_tpu_torch import parallel
    from yolo_tpu_torch.train import loop
    from yolo_tpu_torch.train.__main__ import main
    _, cfg, data, init = train_set
    seen, joined = [], []
    make = loop.make_train_functions

    def record(*a, **k):
        seen.append(k)
        return make(*a, **k)
    monkeypatch.setattr(loop, 'make_train_functions', record)
    monkeypatch.setattr(parallel, 'init_multihost', lambda *a, **k:
                        joined.append(a) or torch.device('cpu'))
    monkeypatch.setattr(torch.distributed, 'destroy_process_group',
                        lambda: None)
    monkeypatch.chdir(tmp_path)
    argv = argv + ['--device', 'cpu']
    r = main(argv + ['--cfg', cfg, '--data', data, '--weights', init,
                     '--epochs', '1', '--batch-size', '4', '--img-size',
                     '64', '--notest', '--nosave'])
    assert len(r) == 7 and np.isfinite(r).all()
    remat = argv[argv.index('--remat') + 1] if '--remat' in argv else 'none'
    assert seen and all(k['mesh'] is None and k['remat'] == remat
                        for k in seen)
    assert all((k['quant_apply'] is not None) == ('--quantized' in argv)
               for k in seen)
    assert joined == ([('localhost:1234',)] if '--coordinator' in argv
                      else [])
    rows = np.loadtxt(tmp_path / 'results.txt', ndmin=2)
    assert rows.shape == (1, 12) and np.isfinite(rows).all()


@pytest.mark.parametrize('argv', [
    ['--evolve', '--bucket', 'b'], ['--device-aug'],
    ['--bucket', 'b', '--name', 'r1']],
    ids=lambda a: a[0].lstrip('-'))
def test_cli_ported_flags_reach_the_loop(argv, tmp_path, monkeypatch):
    """--device-aug and --bucket (with --evolve too) no longer raise: the
    CLI hands them to ``run_training`` (stubbed here; gsutil's runner
    records, no transfer runs)."""
    from yolo_tpu_torch.train import loop
    from yolo_tpu_torch.train.__main__ import main
    from yolo_tpu_torch.utils import gsutil
    opts = []
    monkeypatch.setattr(gsutil, 'runner', lambda cmd: 0)
    monkeypatch.setattr(loop, 'run_training', lambda o: opts.append(o)
                        or (0.5, 0.5, 0.5, 0.5, 1.0, 1.0, 1.0))
    monkeypatch.chdir(tmp_path)
    main(argv + ['--device', 'cpu'])
    o = opts[0]
    assert o.device_aug == ('--device-aug' in argv)
    assert o.bucket == ('b' if '--bucket' in argv else '')
    assert o.name == ('r1' if '--name' in argv else '')
    assert (o.notest and o.nosave) == ('--evolve' in argv)
