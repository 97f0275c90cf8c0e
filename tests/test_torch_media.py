"""The port's live sources and detection on them (``LoadWebcam``,
``LoadStreams``, the stream branch of ``python -m yolo_tpu_torch.detect``)
and the extra masks (``data/augment_extra.py``) against the JAX package,
on the CPU.

A stream's reader thread runs on its own clock, so nothing here waits on
it: a written video has every frame alike (the first batch is then the
same whenever it is read), and the reader's frame choice is held on a
scripted capture object whose thread ends on its own.
"""

import os
import random
import shutil
import sys
import threading

import numpy as np
import pytest

from _torch_port import jax_native, random_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(scope='module', autouse=True)
def _jax_native_loaded():
    """JAX's ``BatchLoader`` takes its native path where ``yolo_tpu.native``
    loads: load it whichever test process built it
    (``_torch_port.jax_native``)."""
    jax_native()

W, H, N_FRAMES = 96, 72, 6


def _write_video(path, n=N_FRAMES):
    """An MJPG .avi (OpenCV writes and reads it without FFmpeg) of ``n``
    identical frames."""
    import cv2
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'MJPG'), 10,
                         (W, H))
    assert vw.isOpened()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    img[20:50, 10:60] = (40, 200, 90)
    for _ in range(n):
        vw.write(img)
    vw.release()
    return str(path)


@pytest.fixture(scope='module')
def videos(tmp_path_factory):
    """Two copies of one video and a streams .txt that lists both."""
    root = tmp_path_factory.mktemp('media')
    a = _write_video(root / 'a.avi')
    b = str(root / 'b.avi')
    shutil.copy(a, b)
    lst = root / 'streams.txt'
    lst.write_text(f'{a}\n{b}\n')
    return a, b, str(lst)


class FakeCapture:
    """A scripted ``cv2.VideoCapture``: ``frames`` in order, ``retrieve``
    failing on the frame numbers in ``bad``; ``done`` is set when ``grab``
    runs out."""

    def __init__(self, frames, bad=()):
        self.frames, self.bad, self.i = frames, set(bad), 0
        self.done = threading.Event()

    def isOpened(self):
        return True

    def set(self, *a):
        return True

    def release(self):
        pass

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1].copy()

    def grab(self):
        if self.i >= len(self.frames):
            self.done.set()
            return False
        self.i += 1
        return True

    def retrieve(self):
        j = self.i - 1
        if j in self.bad:
            return False, None
        return True, self.frames[j].copy()


def _frames(n, h=H, w=W):
    return [np.full((h, w, 3), 10 * k, np.uint8) for k in range(n)]


@pytest.mark.parametrize('which', ['file', 'txt'])
def test_load_streams_first_batch_equal_jax(videos, which):
    from yolo_tpu.data.datasets import LoadStreams as JStreams
    from yolo_tpu_torch.data.datasets import LoadStreams
    src = videos[0] if which == 'file' else videos[2]
    got = next(iter(LoadStreams(src, img_size=64)))
    want = next(iter(JStreams(src, img_size=64)))
    n = 1 if which == 'file' else 2
    assert got[0] == want[0] == list(videos[:n])
    assert got[1].shape == want[1].shape and got[1].shape[:2] == (n, 3)
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    assert got[3] is None


def test_load_streams_reader_keeps_last_good_frame(monkeypatch):
    """Every 4th frame is decoded, a failed decode keeps the frame before
    and the end of the source keeps the last good one, as in JAX: of 10
    frames, 0 is read, 4 decoded and 8 fails."""
    import cv2
    from yolo_tpu.data.datasets import LoadStreams as JStreams
    from yolo_tpu_torch.data.datasets import LoadStreams
    caps = []

    def capture(src):
        caps.append(FakeCapture(_frames(10), bad=(8,)))
        return caps[-1]
    monkeypatch.setattr(cv2, 'VideoCapture', capture)
    got = LoadStreams('rtsp://cam', img_size=64)
    assert caps[-1].done.wait(10)
    got.threads[0].join(10)
    assert not got.threads[0].is_alive()
    want = JStreams('rtsp://cam', img_size=64)
    assert caps[-1].done.wait(10)
    for s in (got, want):
        np.testing.assert_array_equal(s.imgs[0], _frames(10)[4])
    np.testing.assert_array_equal(next(iter(got))[1], next(iter(want))[1])
    assert got.rect is want.rect is True


def test_load_streams_mixed_shapes_turn_rect_off(tmp_path, monkeypatch):
    import cv2
    from yolo_tpu.data.datasets import LoadStreams as JStreams
    from yolo_tpu_torch.data.datasets import LoadStreams

    def capture(src):
        return FakeCapture(_frames(1, 192, 72) if 'tall' in src
                           else _frames(1, 72, 192))
    lst = tmp_path / 's.txt'
    lst.write_text('rtsp://wide\nrtsp://tall\n')
    monkeypatch.setattr(cv2, 'VideoCapture', capture)
    got, want = LoadStreams(str(lst), 128), JStreams(str(lst), 128)
    assert got.rect is want.rect is False
    assert got.sources == want.sources == ['rtsp://wide', 'rtsp://tall']
    batch = next(iter(got))[1]
    assert batch.shape == (2, 3, 128, 128)
    np.testing.assert_array_equal(batch, next(iter(want))[1])


def test_load_webcam_equal_jax(monkeypatch):
    """Camera 0 is mirrored, another pipe is not; a failed read raises."""
    import cv2
    from yolo_tpu.data.datasets import LoadWebcam as JWebcam
    from yolo_tpu_torch.data.datasets import LoadWebcam
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
              for _ in range(2)]
    for pipe in (0, 'rtsp://cam'):
        monkeypatch.setattr(cv2, 'VideoCapture',
                            lambda p: FakeCapture(frames))
        got = [g for _, g in zip(range(2), LoadWebcam(pipe, 64))]
        want = [w for _, w in zip(range(2), JWebcam(pipe, 64))]
        for g, w in zip(got, want, strict=True):
            assert g[0] == w[0] == 'webcam.jpg' and g[3] is w[3] is None
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
        assert np.array_equal(got[0][2], frames[0][:, ::-1]) == (pipe == 0)
    monkeypatch.setattr(cv2, 'VideoCapture', lambda p: FakeCapture([]))
    it = iter(LoadWebcam(1, 64))
    with pytest.raises(RuntimeError, match='Camera Error'):
        next(it)


def _capped(cls, n):
    """``cls`` (a LoadStreams) ending after ``n`` frame steps."""
    class Capped(cls):
        def __next__(self):
            if self.count + 1 >= n:
                raise StopIteration
            return super().__next__()
    return Capped


def _detections(out_dir, name):
    rows = np.loadtxt(os.path.join(out_dir, name), ndmin=2)
    return rows[np.lexsort(rows.T[::-1])]


# one conv+BN, the head conv and a yolo layer: few shapes, so the JAX
# package's eager init and its detect compile stay short
MINI_CFG = """[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14,  23,27,  37,58
classes=2
num=3
"""


def test_detect_on_streams_matches_root(videos, tmp_path, monkeypatch):
    """``python -m yolo_tpu_torch.detect --source streams.txt`` (its
    ``main``) beside the root ``detect.py`` on two streams capped at 3
    frame steps, with ``--view-img --FPGA`` (accepted and ignored by
    both): the same detections a stream. Both run bf16, where the CPU
    convs of the two frameworks round apart: boxes within 0.5 px,
    confidences within 0.01, classes equal; conf 0.83 lies in a gap of
    the scores (3 detections a frame above it, the next at 0.81). The
    port writes each stream into a video of its name; the root CLI writes
    a stream's frames with ``cv2.imwrite``, which OpenCV refuses for a
    video's name, so that side runs with ``imwrite`` replaced."""
    import cv2
    import detect as jdetect
    import yolo_tpu.data.datasets as jdatasets
    from yolo_tpu.ir import build_ir
    from yolo_tpu.utils.checkpoint import save_checkpoint
    from yolo_tpu_torch.data import datasets as tdatasets
    from yolo_tpu_torch.detect import main as tdetect
    cfg = tmp_path / 'mini.cfg'
    cfg.write_text(MINI_CFG)
    pj, sj = random_jax_weights(build_ir(str(cfg)), seed=5, conv_scale=2.5)
    npz = tmp_path / 'mini.npz'
    save_checkpoint(npz, params=pj, state=sj)
    names = tmp_path / 'mini.names'
    names.write_text('a\nb\n')
    monkeypatch.setattr(jdatasets, 'LoadStreams',
                        _capped(jdatasets.LoadStreams, 3))
    monkeypatch.setattr(tdatasets, 'LoadStreams',
                        _capped(tdatasets.LoadStreams, 3))
    argv = ['--cfg', str(cfg), '--weights', str(npz), '--source', videos[2],
            '--img-size', '64', '--conf-thres', '0.83', '--names',
            str(names), '--save-txt', '--view-img', '--FPGA']
    tdetect(argv + ['--output', str(tmp_path / 't'), '--device', 'cpu',
                    '--fourcc', 'MJPG'])
    with monkeypatch.context() as m:
        m.setattr(cv2, 'imwrite', lambda *a, **k: True)
        jdetect.main(argv + ['--output', str(tmp_path / 'j')])
    for stream in ('a', 'b'):
        got = _detections(tmp_path / 't', f'{stream}.txt')
        want = _detections(tmp_path / 'j', f'{stream}.txt')
        assert got.shape == want.shape == (9, 6), (got, want)
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=0.5)
        np.testing.assert_array_equal(got[:, 4], want[:, 4])
        np.testing.assert_allclose(got[:, 5], want[:, 5], atol=0.01)
        cap = cv2.VideoCapture(str(tmp_path / 't' / f'{stream}.avi'))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
        cap.release()


def test_fence_and_grid_masks_equal_jax():
    """The same seeds give the same masks and the same masked batches."""
    from yolo_tpu.data.augment_extra import FenceMask as JFence
    from yolo_tpu.data.augment_extra import GridMask as JGrid
    from yolo_tpu_torch.data.augment_extra import FenceMask, GridMask
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    fences = []
    for cls in (FenceMask, JFence):
        np.random.seed(11)
        fm = cls(batch_size=2, img_size=64, probability=1.0, group_size=2,
                 rng=random.Random(0))
        fences.append((fm, fm(x)))
    (fm, (y, m)), (jfm, (jy, jm)) = fences
    for a, b in zip(fm.group_masks, jfm.group_masks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(m, jm)
    fm.set_prob(0, 10)
    assert fm(x) == (x, None) or fm(x)[1] is None
    img = np.ones((64, 64, 3), np.float32)
    for kw in (dict(rotate=90), dict(rotate=1, mode=1)):
        got = GridMask(16, 32, ratio=0.5, prob=1.0,
                       rng=np.random.default_rng(0), **kw)(img)
        want = JGrid(16, 32, ratio=0.5, prob=1.0,
                     rng=np.random.default_rng(0), **kw)(img)
        np.testing.assert_array_equal(got, want)
        assert 0.05 < got.mean() < 0.95
