"""The port's host library (``yolo_tpu_torch.native`` over
``yolo_tpu_torch/csrc/fastpre.cpp``) and the batch loader's native path
against the JAX package's, on the CPU.

The library is built with the JAX package's g++ flags, so its letterbox
and normalisation are byte-equal to ``yolo_tpu.native``'s; the default
(native) eval batches of both loaders are byte-equal too.
"""

import os
import sys

import numpy as np
import pytest

from _torch_port import jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(scope='module')
def libs():
    """Both host libraries, JAX's loaded whichever test process built it
    (``_torch_port.jax_native``: its in-place build races under several
    workers)."""
    from yolo_tpu_torch import native as N
    J = jax_native()
    assert N.available(), N.build_log()
    assert J.available()
    return N, J


def test_letterbox_and_normalize_byte_equal_jax(libs):
    """On the inputs of tests/test_native.py, with and without scaleup."""
    N, J = libs
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 255, (h, w, 3), np.uint8)
            for h, w in [(240, 320), (480, 360), (100, 500)]]
    for scaleup in (True, False):
        got = N.letterbox_batch(imgs, 416, 416, scaleup=scaleup)
        want = J.letterbox_batch(imgs, 416, 416, scaleup=scaleup)
        assert got[0].shape == (3, 416, 416, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    small = [np.full((100, 100, 3), 7, np.uint8)]
    for g, w in zip(N.letterbox_batch(small, 416, 416, scaleup=False),
                    J.letterbox_batch(small, 416, 416, scaleup=False)):
        np.testing.assert_array_equal(g, w)
    x = np.random.RandomState(1).randint(0, 255, (2, 8, 8, 3), np.uint8)
    for maxabs in (False, True):
        np.testing.assert_array_equal(N.normalize_batch(x, maxabs=maxabs),
                                      J.normalize_batch(x, maxabs=maxabs))
    assert N.num_threads() == J.num_threads() >= 1


@pytest.fixture(scope='module')
def jpeg_list(tmp_path_factory):
    """4 seeded JPEG files of two heights and two widths, one label each
    (tests/test_native.py's set)."""
    import cv2
    root = tmp_path_factory.mktemp('native')
    (root / 'images').mkdir()
    (root / 'labels').mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(4):
        img = rng.randint(0, 255, (rng.choice([200, 300]),
                                   rng.choice([250, 400]), 3), np.uint8)
        p = root / 'images' / f'i{i}.jpg'
        cv2.imwrite(str(p), img)
        (root / 'labels' / f'i{i}.txt').write_text('0 0.5 0.5 0.4 0.4\n')
        paths.append(str(p))
    lst = root / 'val.txt'
    lst.write_text('\n'.join(paths))
    return str(lst)


@pytest.mark.parametrize('rect', [False, True])
def test_default_batches_byte_equal_jax(libs, jpeg_list, rect):
    """``BatchLoader(use_native=None)`` of both packages takes the native
    path on eval data; bs 3 over 4 images leaves a ragged tail."""
    from yolo_tpu.data.datasets import BatchLoader as JLoader
    from yolo_tpu.data.datasets import DetectionDataset as JDataset
    from yolo_tpu_torch.data.datasets import BatchLoader, DetectionDataset
    ds = DetectionDataset(jpeg_list, img_size=128, batch_size=3, rect=rect)
    jds = JDataset(jpeg_list, img_size=128, batch_size=3, rect=rect)
    loader, jloader = BatchLoader(ds, 3, max_targets=16), JLoader(jds, 3,
                                                                 max_targets=16)
    assert loader.use_native and jloader.use_native
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[0].dtype == np.uint8 and g[0].shape == w[0].shape
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert g[3] == w[3] and g[4] == w[4]
    assert got[1][3][1:] == ['', ''] and got[1][4][1:] == [None, None]
    # the cv2 path is another bilinear: labels equal, pixels a unit apart
    cv = list(BatchLoader(ds, 3, max_targets=16, use_native=False))
    np.testing.assert_allclose(cv[0][1], got[0][1], atol=1e-5)
    assert np.median(np.abs(cv[0][0].astype(int) - got[0][0])) <= 1


def test_native_path_rule_and_failures(libs, jpeg_list, monkeypatch):
    """Augmenting and gray datasets stay on the cv2 path; a failure of the
    native path raises instead of falling back, and so does a call without
    the library."""
    from yolo_tpu_torch import native
    from yolo_tpu_torch.data.datasets import BatchLoader, DetectionDataset
    aug = DetectionDataset(jpeg_list, img_size=128, batch_size=2,
                           augment=True, hyp={})
    gray = DetectionDataset(jpeg_list, img_size=128, batch_size=2,
                            is_gray_scale=True)
    assert not BatchLoader(aug, 2).use_native
    assert not BatchLoader(gray, 2).use_native

    def broken(*a, **k):
        raise RuntimeError('letterbox failed')
    monkeypatch.setattr(native, 'letterbox_batch', broken)
    ds = DetectionDataset(jpeg_list, img_size=128, batch_size=2)
    with pytest.raises(RuntimeError, match='letterbox failed'):
        list(BatchLoader(ds, 2))
    monkeypatch.undo()
    monkeypatch.setattr(native, '_load', lambda: None)
    assert not native.available() and native.num_threads() == 0
    assert not BatchLoader(ds, 2).use_native
    with pytest.raises(RuntimeError, match='did not build'):
        native.letterbox_batch([np.zeros((8, 8, 3), np.uint8)], 16, 16)
