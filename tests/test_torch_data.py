"""The port's evaluation data path (``yolo_tpu_torch.data``: the
``DetectionDataset`` in eval mode, ``BatchLoader``, ``resize_to`` and the
label math; ``utils.plots.plot_images``) against the JAX package, on the
CPU.

A synthetic set written with OpenCV (images of several sizes and aspect
ratios, one to three labels each, one image without a label file) goes
through both packages, square and rect, with a ragged tail: every batch
must be bit-equal (the JAX loader with ``use_native=False``, the per-image
path the port copies).
"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_IMAGES = 7


@pytest.fixture(scope='module')
def synth_list(tmp_path_factory):
    """images/ + labels/ + a list txt, as the reference lays a set out."""
    import cv2
    root = tmp_path_factory.mktemp('ds')
    (root / 'images').mkdir()
    (root / 'labels').mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(N_IMAGES):
        h, w = rng.choice([60, 96, 120]), rng.choice([80, 96, 160])
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p = root / 'images' / f'im{i}.png'
        cv2.imwrite(str(p), img)
        if i != 3:                      # one image has no label file
            n = 1 + i % 3
            lab = np.column_stack([rng.randint(0, 3, n),
                                   rng.uniform(0.2, 0.8, (n, 2)),
                                   rng.uniform(0.05, 0.3, (n, 2))])
            (root / 'labels' / f'im{i}.txt').write_text(
                '\n'.join(' '.join(f'{v:.6f}' for v in r) for r in lab) + '\n')
        paths.append(str(p))
    lst = root / 'val.txt'
    lst.write_text('\n'.join(paths))
    return str(lst)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        imgs, tgt, valid, paths, shapes = g
        assert imgs.dtype == np.uint8 and imgs.shape == w[0].shape
        np.testing.assert_array_equal(imgs, w[0])
        np.testing.assert_array_equal(tgt, w[1])
        np.testing.assert_array_equal(valid, w[2])
        assert list(paths) == list(w[3])
        assert shapes == w[4]


@pytest.mark.parametrize('rect', [False, True])
def test_dataset_and_loader_batches_equal_jax(synth_list, rect):
    """bs 3 over 7 images: two full batches and a ragged tail padded with
    zero images and empty paths; rect batches take their shapes from the
    .shapes sidecar (written on the first read, read on the second)."""
    from yolo_tpu.data.datasets import BatchLoader as JLoader
    from yolo_tpu.data.datasets import DetectionDataset as JDataset
    from yolo_tpu_torch.data.datasets import BatchLoader, DetectionDataset
    for _ in range(2):
        jds = JDataset(synth_list, img_size=128, batch_size=3, rect=rect)
        ds = DetectionDataset(synth_list, img_size=128, batch_size=3,
                              rect=rect)
        assert ds.stats == jds.stats == dict(found=6, missing=1, empty=0,
                                             duplicate=0)
        assert ds.img_files == jds.img_files
        if rect:
            np.testing.assert_array_equal(ds.batch_shapes, jds.batch_shapes)
            assert len({tuple(s) for s in ds.batch_shapes}) > 1
        got = list(BatchLoader(ds, 3))
        want = list(JLoader(jds, 3, use_native=False))
        _assert_batches_equal(got, want)
        assert len(got) == 3 and got[-1][3][1:] == ['', '']
    if rect:
        assert os.path.exists(synth_list.replace('.txt', '.shapes'))


def test_subset_weights_and_item_match_jax(synth_list):
    from yolo_tpu.data.datasets import DetectionDataset as JDataset
    from yolo_tpu_torch.data.datasets import DetectionDataset
    ds = DetectionDataset(synth_list, img_size=96, subset_len=5, seed=3,
                          cache_images=True)
    jds = JDataset(synth_list, img_size=96, subset_len=5, seed=3)
    assert ds.img_files == jds.img_files and len(ds) == 5
    for i in range(len(ds)):
        g, w = ds[i], jds[i]
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]
    np.testing.assert_array_equal(ds.class_weights(3), jds.class_weights(3))
    ds.update_image_weights(3, np.array([0.2, 0.5, 0.9]))
    assert len(ds.indices) == 5 and set(ds.indices) <= set(range(5))


def test_transforms_match_jax():
    from yolo_tpu.data import transforms as JT
    from yolo_tpu_torch.data import transforms as TT
    rng = np.random.RandomState(1)
    for h, w in ((60, 200), (300, 100), (50, 40)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for augment in (False, True):
            got, want = TT.resize_to(img, 128, augment), JT.resize_to(img, 128,
                                                                       augment)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    lab = np.column_stack([rng.randint(0, 5, 6), rng.uniform(0, 1, (6, 4))]
                          ).astype(np.float32)
    args = (77, 55, 3.5, 1.0, 0.8, 0.8)
    px = TT.xywhn_to_xyxy_pixels(lab, *args)
    np.testing.assert_array_equal(px, JT.xywhn_to_xyxy_pixels(lab, *args))
    np.testing.assert_array_equal(TT.xyxy2xywh_np(px[:, 1:]),
                                  JT.xyxy2xywh_np(px[:, 1:]))


def test_plot_images_matches_jax(tmp_path):
    from yolo_tpu.utils.plots import plot_images as jplot
    from yolo_tpu_torch.utils.plots import plot_images
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    tgt = np.array([[0, 1, 0.5, 0.5, 0.3, 0.2], [2, 0, 0.3, 0.6, 0.2, 0.4]],
                   np.float32)
    f = str(tmp_path / 'm.jpg')
    got = plot_images(imgs, tgt, fname=f, names=['a', 'b'])
    want = jplot(imgs, tgt, fname=None, names=['a', 'b'])
    np.testing.assert_array_equal(got, want)
    assert os.path.getsize(f) > 0


def test_unported_dataset_options_raise(synth_list):
    from yolo_tpu_torch.data.datasets import DetectionDataset
    for kw in (dict(augment=True), dict(image_weights=True),
               dict(process_shard=(0, 2))):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            DetectionDataset(synth_list, **kw)


def test_loader_surfaces_a_failing_image(tmp_path):
    """An image that cannot be read raises in the consumer instead of
    ending the iteration early."""
    from yolo_tpu_torch.data.datasets import BatchLoader, DetectionDataset
    lst = tmp_path / 'val.txt'
    lst.write_text(str(tmp_path / 'images' / 'missing.png'))
    loader = BatchLoader(DetectionDataset(str(lst), img_size=64), 2)
    with pytest.raises(FileNotFoundError):
        list(loader)
