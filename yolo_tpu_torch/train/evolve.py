"""Hyper-parameter evolution (counterpart of ``yolo_tpu/train/evolve.py``).

``evolve.txt`` holds one row a generation: the 7 results (P, R, mAP@0.5,
F1, val lbox, lobj, lcls), then the 18 hyps of ``HYP_KEYS``, sorted by
fitness. ``mutate_hyp`` picks a parent among the best 5 rows by fitness
and mutates it; its draws come from the ``np.random.Generator`` it is
given, in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..eval.metrics import fitness
from ..utils import gsutil

# hyp keys in evolve.txt column order; gains control mutation strength per key
HYP_KEYS = ['giou', 'cls', 'cls_pw', 'obj', 'obj_pw', 'iou_t', 'lr0', 'lrf',
            'momentum', 'weight_decay', 'fl_gamma', 'hsv_h', 'hsv_s', 'hsv_v',
            'degrees', 'translate', 'scale', 'shear']
GAINS = np.array([1, 1, 1, 1, 1, 1, 1, 0, .1, 1, 0, 1, 1, 1, 1, 1, 1, 1])

LIMITS = {'lr0': (1e-5, 1e-2), 'iou_t': (0.0, 0.70), 'momentum': (0.60, 0.98),
          'weight_decay': (0, 0.001), 'hsv_s': (0, .9), 'hsv_v': (0, .9),
          'translate': (0, .9), 'scale': (0, .9), 'fl_gamma': (0, 3)}


def mutate_hyp(hyp: dict, evolve_file='evolve.txt', rng=None) -> dict:
    """One generation: select a parent from ``evolve_file`` (fitness-
    weighted among the best 5) and mutate it, then clip to ``LIMITS``.
    Without the file the hyp is only clipped. ``rng``: a
    ``np.random.Generator`` (default: a fresh unseeded one)."""
    rng = np.random.default_rng() if rng is None else rng
    hyp = dict(hyp)
    if os.path.exists(evolve_file):
        x = np.loadtxt(evolve_file, ndmin=2)
        n = min(5, len(x))
        x = x[np.argsort(-fitness(x))][:n]
        w = fitness(x) - fitness(x).min() + 1e-6
        idx = rng.choice(n, p=w / w.sum())
        x = x[idx]
        mp, s = 0.9, 0.2
        ng = len(GAINS)
        v = np.ones(ng)
        while (v == 1).all():
            v = (GAINS * (rng.random(ng) < mp) * rng.standard_normal(ng)
                 * rng.random() * s + 1).clip(0.3, 3.0)
        for i, k in enumerate(HYP_KEYS):
            hyp[k] = float(x[i + 7] * v[i])   # results occupy cols 0-6
    for k, (lo, hi) in LIMITS.items():
        hyp[k] = float(np.clip(hyp[k], lo, hi))
    return hyp


def print_mutation(hyp: dict, results, evolve_file='evolve.txt',
                   bucket: str = ''):
    """Append the (results, hyp) row to ``evolve_file``, drop duplicate
    rows and keep it sorted by fitness; with a gsutil ``bucket``, the
    bucket's ``evolve.txt`` is fetched first and the result copied back."""
    if bucket:
        gsutil.download_evolve(bucket, evolve_file)
    b = '%10.3g' * len(HYP_KEYS) % tuple(hyp[k] for k in HYP_KEYS)
    c = '%10.4g' * len(results) % tuple(results)
    print(f'\nEvolved fitness: {c}\n')
    with open(evolve_file, 'a') as f:
        f.write(c + b + '\n')
    x = np.unique(np.loadtxt(evolve_file, ndmin=2), axis=0)
    np.savetxt(evolve_file, x[np.argsort(-fitness(x))], '%10.3g')
    if bucket:
        gsutil.upload_evolve(bucket, evolve_file)


def plot_evolution_results(hyp: dict, evolve_file='evolve.txt',
                           save='evolve.png'):
    """Fitness against each hyp, one scatter a hyp, saved to ``save``;
    None without ``evolve_file``."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    if not os.path.exists(evolve_file):
        return None
    x = np.loadtxt(evolve_file, ndmin=2)
    f = fitness(x)
    fig, axes = plt.subplots(4, 5, figsize=(12, 10), tight_layout=True)
    for i, k in enumerate(HYP_KEYS):
        ax = axes.ravel()[i]
        y = x[:, i + 7]
        ax.plot(y, f, 'o', markersize=3)
        mu = y[f.argmax()] if len(f) else 0
        ax.set_title(f'{k} = {mu:.3g}', fontsize=8)
    fig.savefig(save, dpi=200)
    plt.close(fig)
    return save


def run_evolution(base_opt, hyp0: dict, generations: int = 10,
                  train_fn=None, evolve_file='evolve.txt', rng=None):
    """Mutate -> train -> record, ``generations`` times; returns (best
    fitness, its hyp). ``train_fn(opt, hyp) -> results`` defaults to
    ``run_training`` without evaluation until the last epoch and without
    checkpoints, the hyp handed over through ``TrainOptions.hyp_override``
    (the defaults updated with it, as the JAX package's run trains)."""
    if train_fn is None:
        from .loop import run_training

        def train_fn(opt, hyp):
            return run_training(dataclasses.replace(
                opt, notest=True, nosave=True, hyp_path=None,
                hyp_override=dict(hyp)))

    hyp = dict(hyp0)
    best = None
    for _ in range(generations):
        hyp = mutate_hyp(hyp, evolve_file, rng=rng)
        results = train_fn(base_opt, hyp)
        print_mutation(hyp, tuple(results), evolve_file)
        fi = float(fitness(np.array(results).reshape(1, -1))[0])
        if best is None or fi > best[0]:
            best = (fi, dict(hyp))
    plot_evolution_results(hyp, evolve_file)
    return best
