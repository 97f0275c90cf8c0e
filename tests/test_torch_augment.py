"""The port's training augmentations and shuffled loader
(``yolo_tpu_torch.data``) against the JAX package, on the CPU.

Every comparison is bit for bit: the same ``random.Random(seed)`` drives
``augment_hsv``, ``random_affine``, ``cutout`` and the mosaic on both
sides in the same order, and OpenCV does the pixel work on both. The set
is 8 seeded JPEG files of assorted sizes with random labels.
"""

import os
import random
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HYP = dict(hsv_h=0.0138, hsv_s=0.678, hsv_v=0.36, degrees=5.0,
           translate=0.1, scale=0.1, shear=2.0)


def write_jpeg_set(root, n=8, nc=3, seed=0):
    """``n`` seeded JPEG files of assorted sizes under ``root/images`` with
    random labels under ``root/labels`` (one image without any); returns
    the image-list txt."""
    import cv2
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, 'images'), exist_ok=True)
    os.makedirs(os.path.join(root, 'labels'), exist_ok=True)
    paths = []
    for i in range(n):
        h, w = int(rng.integers(40, 100)), int(rng.integers(40, 100))
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([np.sin(xx / (3 + i)), np.cos(yy / 4),
                         np.sin((xx + yy) / 5)], -1)
        img = np.clip(127 + 90 * base + rng.normal(0, 20, (h, w, 3)), 0,
                      255).astype(np.uint8)
        p = os.path.join(root, 'images', f'im{i}.jpg')
        cv2.imwrite(p, img)
        k = 0 if i == 3 else int(rng.integers(1, 5))
        lab = np.concatenate([rng.integers(0, nc, (k, 1)),
                              rng.uniform(0.25, 0.75, (k, 2)),
                              rng.uniform(0.1, 0.4, (k, 2))], 1)
        np.savetxt(p.replace('images', 'labels').replace('.jpg', '.txt'),
                   lab, fmt='%d %.6f %.6f %.6f %.6f')
        paths.append(p)
    lst = os.path.join(root, 'train.txt')
    with open(lst, 'w') as f:
        f.write('\n'.join(paths) + '\n')
    return lst


@pytest.fixture(scope='module')
def jpeg_set(tmp_path_factory):
    return write_jpeg_set(str(tmp_path_factory.mktemp('set')))


def _image(seed, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def test_augment_hsv_bit_equal():
    from yolo_tpu.data.transforms import augment_hsv as jhsv
    from yolo_tpu_torch.data.transforms import augment_hsv
    for seed in range(3):
        a, b = _image(seed), _image(seed)
        ra, rb = random.Random(seed), random.Random(seed)
        jhsv(a, 0.2, 0.7, 0.4, rnd=ra)
        augment_hsv(b, 0.2, 0.7, 0.4, rnd=rb)
        assert np.array_equal(a, b) and ra.random() == rb.random()


@pytest.mark.parametrize('border', [0, -16])
def test_random_affine_bit_equal(border):
    from yolo_tpu.data.transforms import random_affine as jaff
    from yolo_tpu_torch.data.transforms import random_affine
    rng = np.random.default_rng(1)
    xy = rng.uniform(5, 30, (6, 2))
    t = np.concatenate([rng.integers(0, 3, (6, 1)), xy,
                        xy + rng.uniform(5, 25, (6, 2))], 1)
    for seed in range(3):
        ra, rb = random.Random(seed), random.Random(seed)
        kw = dict(degrees=10, translate=0.1, scale=0.2, shear=5,
                  border=border)
        ia, ta = jaff(_image(seed), t, rnd=ra, **kw)
        ib, tb = random_affine(_image(seed), t, rnd=rb, **kw)
        assert np.array_equal(ia, ib) and np.array_equal(ta, tb)
        assert ta.dtype == tb.dtype == np.float32


def test_cutout_and_bbox_ioa_bit_equal():
    from yolo_tpu.data.transforms import bbox_ioa as jioa
    from yolo_tpu.data.transforms import cutout as jcut
    from yolo_tpu_torch.data.transforms import bbox_ioa, cutout
    rng = np.random.default_rng(2)
    boxes = np.concatenate([rng.uniform(0, 30, (9, 2)),
                            rng.uniform(30, 60, (9, 2))], 1).astype(np.float32)
    box = np.array([10, 5, 40, 35], np.float32)
    assert np.array_equal(bbox_ioa(box, boxes), jioa(box, boxes))
    labels = np.concatenate([np.zeros((9, 1), np.float32), boxes], 1)
    for seed in range(3):
        a, b = _image(seed), _image(seed)
        la = jcut(a, labels.copy(), rnd=random.Random(seed))
        lb = cutout(b, labels.copy(), rnd=random.Random(seed))
        assert np.array_equal(a, b) and np.array_equal(la, lb)


@pytest.mark.parametrize('extra', [False, True], ids=['mosaic', 'cutout_ud'])
def test_augmented_batches_bit_equal(extra, jpeg_set):
    """``DetectionDataset(augment=True)`` (mosaic, affine, HSV, lr flip;
    with ``extra`` also cutout and the up-down flip) through
    ``BatchLoader(shuffle=True, drop_last=True, seed=s)``: two epochs of
    (images, targets, valid mask, paths) equal to JAX's."""
    from yolo_tpu.data.datasets import BatchLoader as JLoader
    from yolo_tpu.data.datasets import DetectionDataset as JDataset
    from yolo_tpu_torch.data.datasets import BatchLoader, DetectionDataset
    kw = dict(img_size=64, batch_size=3, augment=True, hyp=HYP, seed=5,
              cutout=extra, ud_flip=extra)
    jds, tds = JDataset(jpeg_set, **kw), DetectionDataset(jpeg_set, **kw)
    assert tds.mosaic and jds.mosaic
    jl = JLoader(jds, 3, shuffle=True, drop_last=True, seed=7)
    tl = BatchLoader(tds, 3, shuffle=True, drop_last=True, seed=7)
    assert len(tl) == len(jl) == 2
    n = 0
    for _epoch in range(2):
        for a, b in zip(jl, tl, strict=True):
            assert a[0].shape == b[0].shape == (3, 64, 64, 3)
            for x, y in zip(a[:3], b[:3]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            assert list(a[3]) == list(b[3])
            n += int(b[2].sum())
    assert n > 0


def test_plain_augment_without_mosaic_bit_equal(jpeg_set):
    """``rect`` turns the mosaic off: letterbox with scale-up, then affine,
    HSV and the flip, in the batch order of an unshuffled loader."""
    from yolo_tpu.data.datasets import BatchLoader as JLoader
    from yolo_tpu.data.datasets import DetectionDataset as JDataset
    from yolo_tpu_torch.data.datasets import BatchLoader, DetectionDataset
    kw = dict(img_size=64, batch_size=4, augment=True, hyp=HYP, rect=True,
              seed=3)
    jds, tds = JDataset(jpeg_set, **kw), DetectionDataset(jpeg_set, **kw)
    assert not tds.mosaic
    for a, b in zip(JLoader(jds, 4, use_native=False), BatchLoader(tds, 4),
                    strict=True):
        for x, y in zip(a[:3], b[:3]):
            assert np.array_equal(x, y)
        assert a[4] == b[4]


def test_image_weights_resampling_matches_jax(jpeg_set, monkeypatch):
    """``update_image_weights`` draws the same indices as JAX's from the
    same seeded generator, and ``__getitem__`` reads through them."""
    from yolo_tpu.data.datasets import DetectionDataset as JDataset
    from yolo_tpu_torch.data.datasets import DetectionDataset
    kw = dict(img_size=64, batch_size=4, image_weights=True, seed=1)
    jds, tds = JDataset(jpeg_set, **kw), DetectionDataset(jpeg_set, **kw)
    maps = np.array([0.2, 0.9, 0.5])
    real = np.random.default_rng
    monkeypatch.setattr(np.random, 'default_rng', lambda *a: real(11))
    jds.update_image_weights(3, maps)
    tds.update_image_weights(3, maps)
    assert [int(i) for i in tds.indices] == [int(i) for i in jds.indices]
    assert len(set(tds.indices)) < tds.n       # a resampling, not the order
    np.testing.assert_array_equal(tds.class_weights(3), jds.class_weights(3))
    for i in range(tds.n):
        a, b = jds[i], tds[i]
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2] == b[2]
