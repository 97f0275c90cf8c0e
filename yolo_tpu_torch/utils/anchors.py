"""k-means anchors with a genetic refinement (counterpart of
``yolo_tpu/utils/anchors.py``), numpy and scipy on the host.

``scipy.cluster.vq.kmeans`` draws its initial centroids from numpy's
global RNG; the label scales and the mutations come from the
``np.random.Generator`` given, in the JAX package's order.
"""

from __future__ import annotations

import numpy as np


def _wh_iou_np(wh1, wh2):
    inter = np.minimum(wh1[:, None], wh2[None]).prod(2)
    return inter / (wh1[:, None].prod(2) + wh2[None].prod(2) - inter)


def kmean_anchors(path='data_cfg/coco64.txt', n=9, img_size=(320, 1024),
                  thr=0.20, gen=1000, verbose=True, rng=None):
    """(n, 2) anchors in pixels, sorted small to large, for the labels of
    the image list ``path`` (``DetectionDataset(augment=True,
    rect=True)``).

    img_size (min, max): the multi-scale range the label wh are scaled
    over; with min != max the wh set is repeated 10 times at random
    scales. ``gen`` mutations of the k-means anchors are kept where they
    raise the fitness (the mean best IoU above ``thr``)."""
    from ..data.datasets import DetectionDataset
    rng = np.random.default_rng() if rng is None else rng

    ds = DetectionDataset(path, augment=True, rect=True)
    wh = []
    for s, l in zip(ds.shapes, ds.labels):
        if len(l):
            wh.append(l[:, 3:5] * (s / s.max()))
    wh = np.concatenate(wh, 0)
    nr = 1 if img_size[0] == img_size[1] else 10
    wh = wh.repeat(nr, axis=0)
    wh *= rng.uniform(img_size[0], img_size[1], size=(wh.shape[0], 1))
    wh = wh[(wh > 2.0).all(1)]

    def fitness(k):
        iou = _wh_iou_np(wh, k)
        max_iou = iou.max(1)
        return (max_iou * (max_iou > thr)).mean()

    def metrics(k):
        iou = _wh_iou_np(wh, k)
        max_iou = iou.max(1)
        bpr = (max_iou > thr).mean()
        aat = (iou > thr).mean() * n
        return bpr, aat

    from scipy.cluster.vq import kmeans
    s = wh.std(0)
    k, _ = kmeans(wh / s, n, iter=30)
    k *= s

    f, sh, mp, sigma = fitness(k), k.shape, 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random(sh) < mp) * rng.random() * rng.standard_normal(sh)
                 * sigma + 1).clip(0.3, 3.0)
        kg = (k.copy() * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()

    k = k[np.argsort(k.prod(1))]
    if verbose:
        bpr, aat = metrics(k)
        print(f'{thr:.2f} iou_thr: {bpr:.3f} best possible recall, '
              f'{aat:.2f} anchors > thr')
        print(', '.join(f'{round(x[0])},{round(x[1])}' for x in k))
    return k
