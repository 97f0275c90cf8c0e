"""The port's post-training quantization CLI (``python -m
yolo_tpu_torch.ptq``) against the root ``PTQ.py`` of the JAX package, and
the CLIs and evaluator on the other schemes, on the CPU.

Both PTQ CLIs calibrate the same seeded float weights (``PLAIN_CFG``,
tests/test_torch_quant_schemes.py) on the same 8 JPEG files at 64 px:
their quantizer states are equal (votes, scales and counters exactly;
the shortcut trackers' min/max within rtol 1e-5), their BN states within
1e-5 of the norm, and each package reads the other's ``PTQ.npz`` and
``PTQ_qstate.npz``. The port's run with ``--int8-engine`` evaluates the
float model, the sim and the engine (K2's plain version on the CPU).
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import random_jax_weights
from test_torch_augment import write_jpeg_set
from test_torch_qat import _qstate_equal
from test_torch_quant_schemes import PLAIN_CFG
from test_torch_train_step import _close_to_norm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


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
def ptq_set(tmp_path_factory):
    """(root, cfg, .data, float .npz)."""
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils.checkpoint import save_checkpoint
    root = str(tmp_path_factory.mktemp('ptqset'))
    lst = write_jpeg_set(root, n=8, nc=2, seed=6)
    cfg = os.path.join(root, 'plain.cfg')
    with open(cfg, 'w') as f:
        f.write(PLAIN_CFG)
    with open(os.path.join(root, 'names'), 'w') as f:
        f.write('a\nb\n')
    data = os.path.join(root, 'set.data')
    with open(data, 'w') as f:
        f.write(f'classes=2\ntrain={lst}\nvalid={lst}\n'
                f'names={root}/names\n')
    pj, sj = random_jax_weights(build_ir(cfg), seed=8, conv_scale=0.7)
    init = os.path.join(root, 'float.npz')
    save_checkpoint(init, params=pj, state=sj)
    return root, cfg, data, init


def _argv(cfg, data, weights, out):
    return ['--cfg', cfg, '--data', data, '--weights', weights,
            '--img-size', '64', '--batch-size', '2', '--subset-len', '6',
            '--out', out]


@pytest.fixture(scope='module')
def ptq_runs(ptq_set):
    """Both CLIs, --no-eval, into root/jax and root/torch."""
    import PTQ as jptq
    from yolo_tpu_torch import ptq
    root, cfg, data, init = ptq_set
    outs = {}
    for which, main, extra in (('jax', jptq.main, []),
                               ('torch', ptq.main, ['--device', 'cpu'])):
        out = os.path.join(root, which, 'PTQ.npz')
        main(_argv(cfg, data, init, out) + ['--no-eval'] + extra)
        outs[which] = out
    return outs


def test_ptq_cli_matches_jax(ptq_runs, ptq_set):
    """Equal quantizer states, BN states within 1e-5 of the norm, params
    unchanged, and the same extra keys, in the same two files."""
    from yolo_tpu.utils.checkpoint import load_checkpoint as jload
    from yolo_tpu_torch.convert import from_jax, qstate_from_jax
    from yolo_tpu_torch.ir import build_ir
    _, cfg, _, init = ptq_set
    net = build_ir(cfg)
    got, want = jload(ptq_runs['torch']), jload(ptq_runs['jax'])
    assert set(got) == set(want)
    assert (got['quantized'], got['a_bit'], got['w_bit']) == (3, 8, 8)
    qs_t = jload(ptq_runs['torch'].replace('.npz', '_qstate.npz'))['params']
    qs_j = jload(ptq_runs['jax'].replace('.npz', '_qstate.npz'))['params']
    assert _qstate_equal(qstate_from_jax(qs_t), qs_j) > 50
    votes = [float(np.asarray(v['aq']['votes']).sum()) for v in qs_j.values()
             if 'aq' in v]
    assert set(votes) == {3.0}            # 6 images, bs 2: 3 batches
    st_t = from_jax(net, {}, got['state'])[1]
    st_j = from_jax(net, {}, want['state'])[1]
    for k, d in st_j.items():
        for f, w in d.items():
            _close_to_norm(st_t[k][f].numpy(), w.numpy(), 1e-5, f'{k}/{f}')
    f0 = jload(init)['params']
    for k, d in f0.items():
        for f, w in d.items():
            np.testing.assert_array_equal(got['params'][k][f], w)


def test_ptq_files_read_by_both_packages(ptq_runs, ptq_set):
    """The port's load_model(quantized=3) reads JAX's PTQ.npz and its
    sibling qstate, and JAX's load_model reads the port's: each bundle's
    qstate is the file's, and the sims of both on the port's calibration
    give the same eval heads."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu.runtime import load_model as jload_model
    from yolo_tpu.utils.checkpoint import load_checkpoint as jload
    from yolo_tpu_torch.convert import qstate_to_jax
    from yolo_tpu_torch.runtime import load_model
    _, cfg, _, _ = ptq_set
    for src in ('jax', 'torch'):
        path = ptq_runs[src]
        want = jload(path.replace('.npz', '_qstate.npz'))['params']
        tb = load_model(cfg, path, device='cpu', quantized=3)
        _qstate_equal(tb.qstate, want, rtol=0)
        jb = jload_model(cfg, path, quantized=3, compute_dtype=jnp.float32)
        from yolo_tpu_torch.convert import qstate_from_jax
        _qstate_equal(qstate_from_jax(jax.device_get(jb.qstate)), want,
                      rtol=0)
        if src == 'torch':
            x = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3))
            x = (x.astype(np.float32) / 256.0)
            yj = jb.apply(jb.params, jb.state, jnp.asarray(x))[1]
            with torch.no_grad():
                yt = tb.apply(torch.from_numpy(x))[1]
            for a, b in zip(yj, yt):
                _close_to_norm(b.numpy(), np.asarray(a), 1e-5, 'sim heads')
        assert qstate_to_jax(tb.qstate).keys() == want.keys()


def test_ptq_cli_int8_engine_evaluates(ptq_set, tmp_path, capsys):
    """``--int8-engine`` without ``--no-eval``: the float model, the sim
    and the engine are evaluated (finite results, the engine's mAP within
    0.05 of the sim's on the same labels), and the two files written."""
    from yolo_tpu_torch import ptq
    _, cfg, data, init = ptq_set
    out = str(tmp_path / 'w' / 'PTQ8.npz')
    res = ptq.main(_argv(cfg, data, init, out)
                   + ['--int8-engine', '--device', 'cpu'])
    for k in ('float', 'sim', 'engine'):
        assert res[k] is not None and np.isfinite(res[k]).all(), k
    assert abs(res['engine'][2] - res['sim'][2]) <= 0.05
    assert os.path.exists(out) and os.path.exists(
        out.replace('.npz', '_qstate.npz'))
    text = capsys.readouterr().out
    assert 'evaluating the true-int8 engine' in text


@pytest.mark.parametrize('quantized', [2, 3, 4, 5, 6])
def test_test_cli_evaluates_every_scheme(ptq_set, ptq_runs, quantized):
    """``python -m yolo_tpu_torch.test --quantized N`` (in process) loads
    the scheme through load_model and evaluates its sim; on the PTQ file
    (3) also the int8 engine. The results equal ``evaluate`` called on the
    same bundle."""
    from yolo_tpu_torch import test as cli
    from yolo_tpu_torch.eval.evaluator import evaluate
    from yolo_tpu_torch.runtime import load_model
    _, cfg, data, init = ptq_set
    weights = ptq_runs['torch'] if quantized == 3 else init
    base = ['--cfg', cfg, '--data', data, '--weights', weights, '--device',
            'cpu', '--img-size', '64', '--batch-size', '4', '--no-plot',
            '--quantized', str(quantized)]
    got = cli.main(base)
    b = load_model(cfg, weights, device='cpu', quantized=quantized)
    want = evaluate(b.net, b.params, b.state, data, batch_size=4,
                    img_size=64, quant_apply=b.quant_apply(),
                    qstate=b.qstate, device='cpu')[0]
    assert got == want and np.isfinite(got).all()
    if quantized == 3:
        eng = cli.main(base + ['--int8-engine'])
        assert np.isfinite(eng).all() and abs(eng[2] - got[2]) <= 0.05


def test_int8_engine_flag_needs_an_engine_scheme(ptq_set):
    """--int8-engine with a scheme that has no engine exits with the JAX
    CLI's message."""
    from yolo_tpu_torch import test as cli
    _, cfg, data, init = ptq_set
    for q in (-1, 4, 6):
        with pytest.raises(SystemExit, match=r'--quantized \{1,2,3\}'):
            cli.main(['--cfg', cfg, '--data', data, '--weights', init,
                      '--device', 'cpu', '--int8-engine', '--quantized',
                      str(q)])


def test_sparse_eval_of_the_sim_matches_dense(ptq_set, ptq_runs):
    """``evaluate(sparse=True)`` runs a sim through its heads-only twin
    into the sparse NMS, with the same results as the dense path (the JAX
    package's own test), for a QAT training apply too (bf16 MACs, NHWC
    heads, bf16 eval snaps)."""
    from yolo_tpu_torch.compress.quant import make_quant_apply
    from yolo_tpu_torch.eval.evaluator import evaluate
    from yolo_tpu_torch.runtime import load_model
    _, cfg, data, _ = ptq_set
    b = load_model(cfg, ptq_runs['torch'], device='cpu', quantized=3)
    train_apply = make_quant_apply(b.net, b.qcfg, compute_dtype=torch.bfloat16,
                                   eval_snap_dtype=torch.bfloat16,
                                   head_layout='nhwc')
    for qapply in (b.quant_apply(), train_apply):
        res = [evaluate(b.net, b.params, b.state, data, batch_size=4,
                        img_size=64, quant_apply=qapply, qstate=b.qstate,
                        sparse=sp, device='cpu')[:2] for sp in (False, True)]
        np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5,
                                   atol=1e-6)
