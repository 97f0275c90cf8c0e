"""The port's hyper-parameter evolution (``yolo_tpu_torch.train.evolve``,
``python -m yolo_tpu_torch.train --evolve``) and k-means anchors
(``yolo_tpu_torch.utils.anchors``) against the JAX package, on the CPU.

Both packages draw from ``np.random.Generator``s seeded alike (and
``scipy.cluster.vq.kmeans`` from numpy's global RNG, seeded before each
call): ``mutate_hyp`` and ``run_evolution`` give equal hyps,
``print_mutation`` byte-equal ``evolve.txt`` files, and ``kmean_anchors``
anchors within rtol 1e-6.
"""

import os
import sys

import numpy as np
import pytest

from _torch_port import TOY_CFG
from test_torch_augment import write_jpeg_set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _results(rng):
    """A results tuple (P, R, mAP@0.5, F1, val lbox, lobj, lcls)."""
    return tuple(float(v) for v in rng.uniform(0.01, 0.9, 7))


def _evolve_file(path, generations=4, seed=0):
    """An evolve.txt of ``generations`` rows written by the JAX package."""
    from yolo_tpu.config import load_hyp
    from yolo_tpu.train.evolve import mutate_hyp, print_mutation
    rng = np.random.default_rng(seed)
    for _ in range(generations):
        hyp = mutate_hyp(load_hyp(None), str(path), rng=rng)
        print_mutation(hyp, _results(rng), str(path))
    return str(path)


@pytest.mark.parametrize('with_file', [False, True])
def test_mutate_hyp_matches_jax(with_file, tmp_path):
    """The same hyp from equal Generators, and the Generators left in the
    same state; without evolve.txt the hyp is only clipped to LIMITS."""
    from yolo_tpu.config import load_hyp as jload
    from yolo_tpu.train import evolve as J
    from yolo_tpu_torch.config import load_hyp
    from yolo_tpu_torch.train import evolve as T
    assert T.HYP_KEYS == J.HYP_KEYS and T.LIMITS == J.LIMITS
    np.testing.assert_array_equal(T.GAINS, J.GAINS)
    path = (_evolve_file(tmp_path / 'evolve.txt') if with_file
            else str(tmp_path / 'none.txt'))
    assert load_hyp(None) == jload(None)
    for seed in range(5):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        want = J.mutate_hyp(jload(None), path, rng=rj)
        got = T.mutate_hyp(load_hyp(None), path, rng=rt)
        assert got == want
        assert rt.random() == rj.random()
        if not with_file:
            assert got == {**load_hyp(None), **{
                k: float(np.clip(load_hyp(None)[k], lo, hi))
                for k, (lo, hi) in T.LIMITS.items()}}
    assert with_file == (got != load_hyp(None))


def test_print_mutation_byte_equal(tmp_path, capsys, monkeypatch):
    """Five generations appended by each package: evolve.txt byte-equal
    (rows deduplicated and sorted by fitness), the same printed lines; with
    a bucket, the same gsutil transfers around the append (through a
    recording runner: no transfer runs)."""
    from yolo_tpu.config import load_hyp
    from yolo_tpu.train import evolve as J
    from yolo_tpu_torch.train import evolve as T
    rng = np.random.default_rng(7)
    jf, tf = str(tmp_path / 'j.txt'), str(tmp_path / 't.txt')
    rows = [(J.mutate_hyp(load_hyp(None), jf, rng=np.random.default_rng(i)),
             _results(rng)) for i in range(4)]
    # the hyps repeated: their results print at 4 digits and are kept at
    # 3, so the rows stay apart, in both packages alike
    rows.append(rows[1])
    for hyp, res in rows:
        J.print_mutation(hyp, res, jf)
        want = capsys.readouterr().out
        T.print_mutation(hyp, res, tf)
        assert capsys.readouterr().out == want
        assert open(tf, 'rb').read() == open(jf, 'rb').read()
    assert np.loadtxt(tf, ndmin=2).shape == (5, 25)
    from yolo_tpu.utils import gsutil as jgsutil
    from yolo_tpu_torch.utils import gsutil as tgsutil
    calls = {}
    for mod, f, name, pm in ((jgsutil, jf, 'jax', J.print_mutation),
                             (tgsutil, tf, 'torch', T.print_mutation)):
        got = calls[name] = []
        monkeypatch.setattr(mod, 'runner',
                            lambda cmd, got=got: got.append(cmd) or 0)
        pm(rows[0][0], rows[0][1], f, bucket='b')
        got[:] = [[a.replace(f, 'evolve.txt') for a in c] for c in got]
    assert calls['torch'] == calls['jax'] == [
        ['gsutil', 'cp', 'gs://b/evolve.txt', 'evolve.txt'],
        ['gsutil', 'cp', 'evolve.txt', 'gs://b/evolve.txt']]
    assert open(tf, 'rb').read() == open(jf, 'rb').read()


def test_run_evolution_matches_jax(tmp_path, monkeypatch):
    """``run_evolution`` with a train function of the hyp: the same best
    (fitness, hyp), byte-equal evolve.txt, the plot written."""
    from yolo_tpu.config import load_hyp
    from yolo_tpu.train import evolve as J
    from yolo_tpu_torch.train import evolve as T
    monkeypatch.chdir(tmp_path)

    def train_fn(opt, hyp):
        r = np.random.default_rng(int(hyp['lr0'] * 1e7) % 1000)
        return _results(r)

    out = {}
    for name, mod in (('j', J), ('t', T)):
        f = str(tmp_path / f'{name}.txt')
        out[name] = mod.run_evolution(None, load_hyp(None), generations=3,
                                      train_fn=train_fn, evolve_file=f,
                                      rng=np.random.default_rng(2))
        out[name + 'bytes'] = open(f, 'rb').read()
    assert out['t'] == out['j']
    assert out['tbytes'] == out['jbytes']
    assert (tmp_path / 'evolve.png').stat().st_size > 0
    assert T.plot_evolution_results({}, str(tmp_path / 'none.txt')) is None


def test_run_evolution_trains_the_jax_hyp(tmp_path, monkeypatch):
    """The default train function hands the mutated hyp to
    ``run_training`` through ``hyp_override``, without evaluation and
    checkpoints: the run trains the hyp JAX's run would (its defaults
    updated with the mutated values)."""
    from yolo_tpu.config import DEFAULT_HYP as JDEFAULT
    from yolo_tpu_torch.config import load_hyp
    from yolo_tpu_torch.train import evolve as T
    from yolo_tpu_torch.train import loop
    monkeypatch.chdir(tmp_path)
    seen = []

    def fake_run(opt):
        seen.append(opt)
        return (0.1, 0.2, 0.3, 0.2, 1.0, 2.0, 0.5)

    monkeypatch.setattr(loop, 'run_training', fake_run)
    hyp0 = {'lr0': 0.005, 'momentum': 0.9, 'giou': 3.0}
    base = loop.TrainOptions(cfg='x.cfg', hyp_path='h.txt')
    T.run_evolution(base, {**load_hyp(None), **hyp0}, generations=2,
                    rng=np.random.default_rng(0))
    assert len(seen) == 2
    for opt in seen:
        assert opt.notest and opt.nosave and opt.hyp_path is None
        trained = {**load_hyp(opt.hyp_path), **opt.hyp_override}
        assert trained == {**JDEFAULT, **opt.hyp_override}
    assert seen[0].hyp_override != seen[1].hyp_override


@pytest.fixture(scope='module')
def label_set(tmp_path_factory):
    """(root, image list, .data, cfg) over 8 seeded JPEG files."""
    root = str(tmp_path_factory.mktemp('evolveset'))
    lst = write_jpeg_set(root, n=8, nc=2, seed=6)
    cfg = os.path.join(root, 'toy.cfg')
    with open(cfg, 'w') as f:
        f.write(TOY_CFG)
    with open(os.path.join(root, 'names'), 'w') as f:
        f.write('a\nb\n')
    data = os.path.join(root, 'set.data')
    with open(data, 'w') as f:
        f.write(f'classes=2\ntrain={lst}\nvalid={lst}\n'
                f'names={root}/names\n')
    return root, lst, data, cfg


def test_evolve_cli_two_generations(label_set, tmp_path, monkeypatch):
    """``python -m yolo_tpu_torch.train --evolve`` twice (its ``main``, 1
    epoch at 64 px): evolve.txt holds 2 rows of 7 results + 18 hyps, and
    no checkpoint is written (evolve implies notest/nosave). A third
    generation with ``--bucket`` (its training stubbed, gsutil's runner
    recording) fetches the bucket's evolve.txt before the mutation and
    around the append, and copies it back, as the root train.py does."""
    from yolo_tpu_torch.train.__main__ import main
    _, _, data, cfg = label_set
    monkeypatch.chdir(tmp_path)
    for _ in range(2):
        res = main(['--cfg', cfg, '--data', data, '--epochs', '1',
                    '--batch-size', '4', '--img-size', '64', '64', '64',
                    '--evolve', '--device', 'cpu'])
        assert len(res) == 7
    rows = np.loadtxt('evolve.txt', ndmin=2)
    assert rows.shape[0] == 2 and rows.shape[1] >= 7 + 18
    assert not os.path.exists('weights/best.npz')
    assert not os.path.exists('weights/last.npz')
    from yolo_tpu_torch.train import loop
    from yolo_tpu_torch.utils import gsutil
    calls = []
    monkeypatch.setattr(gsutil, 'runner', lambda cmd: calls.append(cmd) or 0)
    monkeypatch.setattr(loop, 'run_training',
                        lambda opt: (0.5, 0.5, 0.5, 0.5, 1.0, 1.0, 1.0))
    main(['--cfg', cfg, '--data', data, '--evolve', '--bucket', 'b',
          '--device', 'cpu'])
    assert calls == [['gsutil', 'cp', 'gs://b/evolve.txt', 'evolve.txt'],
                     ['gsutil', 'cp', 'gs://b/evolve.txt', 'evolve.txt'],
                     ['gsutil', 'cp', 'evolve.txt', 'gs://b/evolve.txt']]
    assert np.loadtxt('evolve.txt', ndmin=2).shape[0] == 3


@pytest.mark.parametrize('img_size', [(64, 64), (48, 128)])
def test_kmean_anchors_matches_jax(img_size, label_set, capsys):
    """k-means + 200 genetic mutations over the 8 files' labels, the
    multi-scale range too (each wh 10 times at random scales): the same
    anchors within rtol 1e-6 and the same printed recall."""
    from yolo_tpu.utils.anchors import kmean_anchors as J
    from yolo_tpu_torch.utils.anchors import kmean_anchors as T
    _, lst, _, _ = label_set
    out = []
    for fn in (J, T):
        np.random.seed(0)
        k = fn(lst, n=4, img_size=img_size, gen=200,
               rng=np.random.default_rng(0))
        out.append((k, capsys.readouterr().out))
    (kj, pj), (kt, pt) = out
    assert kt.shape == (4, 2) and (np.diff(kt.prod(1)) >= 0).all()
    np.testing.assert_allclose(kt, kj, rtol=1e-6)
    assert pt == pj and 'best possible recall' in pt
