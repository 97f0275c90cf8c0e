"""The port's host utilities against the JAX package's, on the CPU:
``utils/gsutil.py`` (``--bucket`` in the loop: ``test_torch_device_aug.py``;
in the CLI and evolve: ``test_torch_evolve.py``, ``test_torch_train_loop.py``),
``utils/checkpoint.py`` ``strip_optimizer``, ``utils/plots.py``
``plot_results``, ``utils/downloads.py`` (through an injected opener: no
test opens the network), ``utils/dev.py`` and ``utils/profiler.py``.

The plots are drawn at a low resolution here (``Figure.savefig`` at 20
dpi): what is held is that each helper draws and writes its file.
"""

import io
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture
def low_dpi(monkeypatch):
    import matplotlib
    matplotlib.use('Agg')
    from matplotlib.figure import Figure
    save = Figure.savefig

    def savefig(self, *a, **k):
        k['dpi'] = 20
        return save(self, *a, **k)
    monkeypatch.setattr(Figure, 'savefig', savefig)


# ---------------------------------------------------------------- gsutil

def test_gsutil_commands_equal_jax(monkeypatch):
    """The transfers of tests/test_aux.py, through both packages."""
    from yolo_tpu.utils import gsutil as J
    from yolo_tpu_torch.utils import gsutil as G
    calls = {}
    for name, mod in (('jax', J), ('torch', G)):
        got = calls[name] = []
        monkeypatch.setattr(mod, 'runner', lambda cmd, got=got:
                            got.append(cmd) or 0)
        mod.sync_results('bkt', 'run1', 'res.txt')
        mod.download_evolve('bkt')
        mod.upload_evolve('bkt')
        mod.upload_weights('bkt', 'weights/best.npz')
        mod.sync_results('', 'run1')
        mod.sync_results('bkt', '')
    assert calls['torch'] == calls['jax'] == [
        ['gsutil', 'cp', 'res.txt', 'gs://bkt/results/resultsrun1.txt'],
        ['gsutil', 'cp', 'gs://bkt/evolve.txt', 'evolve.txt'],
        ['gsutil', 'cp', 'evolve.txt', 'gs://bkt/evolve.txt'],
        ['gsutil', 'cp', 'weights/best.npz', 'gs://bkt/weights/best.npz'],
    ]
    assert G._run(['gsutil-not-installed-here', 'cp', 'a', 'b']) != 0


# ------------------------------------------------------------ checkpoints

def _ckpt_trees(seed):
    rng = np.random.default_rng(seed)
    params = {'0': {'w': rng.normal(size=(3, 3, 3, 4)).astype(np.float32)}}
    state = {'0': {'mean': rng.normal(size=4).astype(np.float32)}}
    ema = {'0': {'w': rng.normal(size=(3, 3, 3, 4)).astype(np.float32)}}
    ema_state = {'0': {'mean': rng.normal(size=4).astype(np.float32)}}
    return params, state, ema, ema_state


@pytest.mark.parametrize('opt_form', ['named', 'positional'])
def test_strip_optimizer_equal_jax(tmp_path, opt_form):
    """A checkpoint with the optimizer state in the port's named form or
    in the JAX package's positional one, stripped by both packages: the
    same file contents (the EMA pair promoted, no optimizer state)."""
    from yolo_tpu.utils.checkpoint import load_checkpoint as jload
    from yolo_tpu.utils.checkpoint import strip_optimizer as jstrip
    from yolo_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint,
                                                 strip_optimizer)
    params, state, ema, ema_state = _ckpt_trees(0)
    opt_state = ({'momentum_buf': params} if opt_form == 'named'
                 else [params])
    out = {}
    for name, strip in (('torch', strip_optimizer), ('jax', jstrip)):
        path = tmp_path / f'{name}.npz'
        save_checkpoint(path, params=params, state=state, epoch=3,
                        best_fitness=0.25, training_results='r',
                        opt_state=opt_state, ema=ema, ema_state=ema_state,
                        extra={'ema_updates': 7})
        strip(path)
        out[name] = jload(path)
        assert load_checkpoint(path).keys() == out[name].keys()
    t, j = out['torch'], out['jax']
    assert 'opt_state' not in t and 'ema' not in t
    assert t.keys() == j.keys()
    assert (t['epoch'], t['best_fitness'], t['training_results']) == (
        3, 0.25, 'r')
    np.testing.assert_array_equal(t['params']['0']['w'], ema['0']['w'])
    np.testing.assert_array_equal(t['state']['0']['mean'],
                                  ema_state['0']['mean'])
    np.testing.assert_array_equal(t['params']['0']['w'],
                                  j['params']['0']['w'])
    # without the EMA pair the raw one stays
    p = tmp_path / 'raw.npz'
    save_checkpoint(p, params=params, state=state, opt_state=opt_state)
    strip_optimizer(p)
    np.testing.assert_array_equal(jload(p)['params']['0']['w'],
                                  params['0']['w'])


# ------------------------------------------------------------------ plots

def test_plot_results_writes_png(tmp_path, low_dpi):
    from yolo_tpu_torch.utils.plots import plot_results
    res = np.zeros((3, 12))
    res[:, 0] = np.arange(3)
    res[:, 1:] = np.linspace(0.2, 0.8, 33).reshape(3, 11)
    np.savetxt(tmp_path / 'results.txt', res, fmt='%10.4g')
    out = plot_results(str(tmp_path / 'results.txt'),
                       str(tmp_path / 'results.png'))
    assert out == str(tmp_path / 'results.png') and os.path.getsize(out) > 0
    assert plot_results(str(tmp_path / 'missing.txt')) is None
    (tmp_path / 'empty.txt').write_text('')
    assert plot_results(str(tmp_path / 'empty.txt')) is None


# -------------------------------------------------------------- downloads

class _FakeResponse(io.BytesIO):
    def __init__(self, payload: bytes, ctype='application/octet-stream'):
        super().__init__(payload)
        self.headers = {'Content-Type': ctype}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _FakeOpener:
    """url-substring -> response factory; records every url."""

    def __init__(self, routes):
        self.routes, self.calls = routes, []

    def open(self, url, timeout=None):
        self.calls.append(url)
        for frag, make in self.routes:
            if frag in url:
                return make()
        raise OSError(f'no route for {url}')


def test_attempt_download_local_and_drive(tmp_path):
    from yolo_tpu_torch.utils import downloads as D
    f = tmp_path / 'x.weights'
    f.write_bytes(b'123')
    assert D.attempt_download(str(f)) == str(f)
    assert D.attempt_download('') == ''
    blob = b'w' * 1_100_000
    op = _FakeOpener([('drive.google.com', lambda: _FakeResponse(blob))])
    dest = tmp_path / 'yolov3.weights'
    assert D.attempt_download(str(dest), opener=op) == str(dest)
    assert dest.read_bytes() == blob
    assert D.GDRIVE_IDS['yolov3.weights'] in op.calls[0]


def test_attempt_download_confirm_token_and_pjreddie(tmp_path):
    from yolo_tpu.utils import downloads as J
    from yolo_tpu_torch.utils import downloads as D
    assert D.GDRIVE_IDS == J.GDRIVE_IDS
    blob = b'W' * 1_200_000
    op = _FakeOpener([
        ('confirm=AbC123', lambda: _FakeResponse(blob)),
        ('drive.google.com', lambda: _FakeResponse(
            b'<a href="...confirm=AbC123&amp;id=x">', ctype='text/html'))])
    dest = tmp_path / 'yolov3-tiny.weights'
    assert D.attempt_download(str(dest), opener=op) == str(dest)
    assert dest.read_bytes() == blob and len(op.calls) == 2
    op = _FakeOpener([('pjreddie.com/media/files/custom.weights',
                       lambda: _FakeResponse(b'p' * 1_050_000))])
    dest = tmp_path / 'custom.weights'
    assert D.attempt_download(str(dest), opener=op) == str(dest)


def test_attempt_download_rejects_partial(tmp_path):
    from yolo_tpu_torch.utils import downloads as D
    op = _FakeOpener([('drive.google.com', lambda: _FakeResponse(b'tiny'))])
    dest = tmp_path / 'yolov3.weights'
    with pytest.raises(FileNotFoundError, match='drive.google.com'):
        D.attempt_download(str(dest), opener=op)
    assert not dest.exists()
    with pytest.raises(FileNotFoundError, match='pjreddie.com'):
        D.attempt_download(str(tmp_path / 'other.weights'),
                           opener=_FakeOpener([]))


# -------------------------------------------------------------------- dev

@pytest.fixture
def label_dir(tmp_path):
    """labels/ and images/ of three images (tests/test_aux.py's set)."""
    import cv2
    (tmp_path / 'labels').mkdir()
    (tmp_path / 'images').mkdir()
    rows = {'a': [[0, .5, .5, .2, .2], [0, .3, .3, .1, .1]],
            'b': [[2, .5, .5, .2, .2]],
            'c': [[0, .4, .4, .2, .2], [2, .6, .6, .1, .1]]}
    rng = np.random.default_rng(0)
    for name, rr in rows.items():
        (tmp_path / 'labels' / f'{name}.txt').write_text(
            '\n'.join(' '.join(str(v) for v in r) for r in rr) + '\n')
        cv2.imwrite(str(tmp_path / 'images' / f'{name}.jpg'),
                    rng.integers(0, 256, (64, 80, 3), dtype=np.uint8))
    return tmp_path


def test_dev_coco_class_count(label_dir):
    from yolo_tpu.utils import dev as J
    from yolo_tpu_torch.utils import dev
    got = dev.coco_class_count(str(label_dir / 'labels'), nc=5)
    assert got.tolist() == [3, 0, 2, 0, 0]
    assert got.tolist() == J.coco_class_count(str(label_dir / 'labels'),
                                              nc=5).tolist()


def test_dev_coco_only_people(label_dir):
    from yolo_tpu_torch.utils import dev
    people = dev.coco_only_people(str(label_dir / 'labels'))
    assert [(n, os.path.basename(f)) for n, f in people] == [(2, 'a.txt')]


def test_dev_coco_single_class_labels(label_dir):
    from yolo_tpu.utils import dev as J
    from yolo_tpu_torch.utils import dev
    for name, mod in (('t', dev), ('j', J)):
        mod.coco_single_class_labels(str(label_dir / 'labels'),
                                     label_class=2,
                                     out_dir=str(label_dir / name))
    for sub in ('labels', 'images'):
        kept = sorted(os.listdir(label_dir / 't' / sub))
        assert kept == sorted(os.listdir(label_dir / 'j' / sub))
    assert sorted(os.listdir(label_dir / 't' / 'labels')) == ['b.txt',
                                                              'c.txt']
    for f in ('labels/c.txt', 'labels/b.txt', 'images.txt'):
        assert (label_dir / 't' / f).read_text() == (
            label_dir / 'j' / f).read_text().replace(str(label_dir / 'j'),
                                                     str(label_dir / 't'))


def test_dev_crop_images_random_equal_jax(label_dir, tmp_path_factory):
    import shutil
    import cv2
    from yolo_tpu.utils import dev as J
    from yolo_tpu_torch.utils import dev
    other = tmp_path_factory.mktemp('crop') / 'images'
    shutil.copytree(label_dir / 'images', other)
    dev.crop_images_random(str(label_dir / 'images'), seed=0)
    J.crop_images_random(str(other), seed=0)
    for name in ('a', 'b', 'c'):
        got = cv2.imread(str(label_dir / 'images' / f'{name}.jpg'))
        want = cv2.imread(str(other / f'{name}.jpg'))
        assert got.shape[0] < 64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_dev_print_model_biases_equal_jax(tmp_path):
    """The port's params (torch) and the JAX package's print the same
    summary."""
    from _torch_port import TOY_CFG, random_jax_weights
    from yolo_tpu.ir import build_ir as jbuild
    from yolo_tpu.utils import dev as J
    from yolo_tpu_torch.convert import from_jax
    from yolo_tpu_torch.ir import build_ir
    from yolo_tpu_torch.utils import dev
    cfg = tmp_path / 'toy.cfg'
    cfg.write_text(TOY_CFG)
    net = build_ir(str(cfg))
    pj, sj = random_jax_weights(net, seed=1)
    pt, _ = from_jax(net, pj, sj)
    got, want = [], []
    dev.print_model_biases(net, pt, log=got.append)
    J.print_model_biases(jbuild(str(cfg)), pj, log=want.append)
    assert got == want and len(got) == 3 and '+/-' in got[1]


def test_dev_create_backbone(tmp_path):
    from yolo_tpu_torch.utils import dev
    from yolo_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    params, state, _, _ = _ckpt_trees(1)
    save_checkpoint(tmp_path / 'last.npz', params=params, state=state,
                    epoch=7, best_fitness=0.5, training_results='x',
                    opt_state={'momentum_buf': params})
    out = dev.create_backbone(str(tmp_path / 'last.npz'),
                              str(tmp_path / 'backbone.npz'))
    bk = load_checkpoint(out)
    assert int(bk['epoch']) == -1 and 'opt_state' not in bk
    assert bk['training_results'] == ''
    np.testing.assert_array_equal(bk['params']['0']['w'], params['0']['w'])


def test_dev_select_best_evolve(tmp_path):
    from yolo_tpu_torch.utils import dev
    (tmp_path / 'evolve.txt').write_text(
        ' '.join(['0.1'] * 12) + '\n' + ' '.join(['0.9'] * 12) + '\n')
    best = dev.select_best_evolve(str(tmp_path / 'evolve*.txt'),
                                  log=lambda *a: None)
    assert len(best) == 1 and best[0][1][0] == np.float32(0.9)


def test_dev_apply_classifier_equal_jax():
    from yolo_tpu.utils import dev as J
    from yolo_tpu_torch.utils import dev
    dets = [np.array([[2, 2, 20, 20, 0.9, 0],
                      [30, 30, 60, 60, 0.8, 1]], np.float32), None]
    im0 = np.random.default_rng(2).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    seen = []

    def classify(batch):
        seen.append(batch)
        return np.zeros(len(batch), int)
    got = dev.apply_classifier(dets, classify, (64, 64), [im0, im0])
    want = J.apply_classifier(dets, classify, (64, 64), [im0, im0])
    assert len(got[0]) == 1 and got[0][0, 5] == 0 and got[1] is None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(seen[0], seen[1])
    assert seen[0].shape == (2, 224, 224, 3)


@pytest.mark.parametrize('helper', ['plot_wh_methods', 'plot_test_txt',
                                    'plot_targets_txt',
                                    'plot_results_overlay'])
def test_dev_plots_write_files(helper, tmp_path, monkeypatch, low_dpi):
    from yolo_tpu_torch.utils import dev
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(0)
    if helper == 'plot_wh_methods':
        assert os.path.getsize(dev.plot_wh_methods('cmp.png')) > 0
    elif helper == 'plot_test_txt':
        np.savetxt('test.txt', rng.rand(50, 4) * 64)
        dev.plot_test_txt('test.txt')
        assert os.path.exists('hist2d.png') and os.path.exists('hist1d.png')
    elif helper == 'plot_targets_txt':
        np.savetxt('targets.txt', rng.rand(50, 4))
        assert os.path.exists(dev.plot_targets_txt('targets.txt', 'tg.jpg'))
    else:
        res = np.zeros((3, 12))
        res[:, 0] = np.arange(3)
        res[:, 1:] = 0.5
        np.savetxt('results.txt', res, fmt='%10.4g')
        saved = dev.plot_results_overlay(pattern='results*.txt')
        assert saved == ['results.png'] and os.path.exists(saved[0])


# --------------------------------------------------------------- profiler

def test_profiler(tmp_path):
    """``trace(logdir)`` writes a Chrome trace that holds the program's
    spans, and ``summary()`` then gives their totals."""
    import torch
    from yolo_tpu_torch.utils.profiler import reset, span, summary, trace
    reset()
    with trace(str(tmp_path / 'tr')) as prof:
        with span('serve.infer'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    names = [e.get('name') for e in events['traceEvents']]
    assert 'serve.infer' in names
    assert summary()['spans']['serve.infer']['count'] == 1
    reset()
