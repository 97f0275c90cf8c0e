"""The numbers that decide ``correct``: the program's outputs held against
the plain reference's, each number with a limit of its own.

Detections (serving): the served detections of an image against the
reference's (the same decode, candidate rule, suppression and merge,
``reference/detect.py``), each number the mean over the sampled images.
``off_share.<t>``: the share of the reference's ``top`` best detections
that no served detection holds, one of its class overlapping it at IoU
>= 0.5 with a score within t% of its score (a dropped or relabelled
image, a wrong score or box; ``missed_mean``: the same with any score).
``score_sum_gap``: the gap between the sums of the served and the
reference's scores, over the reference's. ``mass_gap``: the L1 distance
between the two sides' score mass by class, over the reference's mass
(a relabelled image reads about 2, a dropped one 1).

Training: the loss of each of the first steps, the norm of each leaf's
first gradient, and the norm of each leaf's change over the first steps
(the parameters; their moving average, with the BN statistics'; the BN
running statistics), each as the gap between the program's and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger; the worst leaf counts. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from .reference.detect import iou_matrix

MATCH_IOU = 0.5
TOLS = (20, 30, 45)          # a score's tolerance, in % of the reference's


def _class_mass(d, nc):
    return torch.zeros(nc, device=d.device).index_add_(
        0, d[:, 5].long().clamp(0, nc - 1), d[:, 4])


def detections(served, ref_dets, top, nc):
    """served: per image an (n, 6) array or None; ref_dets: per image the
    reference's (d, 6) tensor, best first; nc the classes."""
    per = {k: [] for k in ('score_sum_gap', 'mass_gap', 'missed_mean')
           + tuple(f'off_share.{t}' for t in TOLS)}
    for got, want in zip(served, ref_dets):
        got = (want.new_zeros((0, 6)) if got is None else
               torch.as_tensor(np.asarray(got), dtype=torch.float32,
                               device=want.device))
        got = got[got[:, 4] > 0]                 # empty slots are all zero
        if not len(want):
            continue
        sw = float(want[:, 4].sum())
        per['score_sum_gap'].append(abs(float(got[:, 4].sum()) - sw) / sw)
        per['mass_gap'].append(float((_class_mass(got, nc)
                                      - _class_mass(want, nc)).abs().sum())
                               / sw)
        w = want[:top]
        pair = ((iou_matrix(got[:, :4], w[:, :4]) >= MATCH_IOU)
                & (got[:, 5:6] == w[:, 5][None]))                  # (n, t)
        # each of the reference's best: its counterpart nearest in score
        near = torch.where(pair, (got[:, 4:5] - w[:, 4][None]).abs(),
                           float('inf')).amin(0) if len(got) else \
            torch.full_like(w[:, 4], float('inf'))
        per['missed_mean'].append(float(torch.isinf(near).float().mean()))
        for t in TOLS:
            per[f'off_share.{t}'].append(
                float((near > t / 100 * w[:, 4]).float().mean()))
    return {k: sum(v) / max(len(v), 1) for k, v in per.items()}


def leaf_gaps(got, want, skip=()):
    """Each leaf's |got - want| / max(want, median of want) over the
    leaves' norms (dicts of floats), leaving out ``skip``."""
    med = statistics.median(want.values())
    return {k: abs(got[k] - w) / max(w, med, 1e-30)
            for k, w in want.items() if k not in skip}


def training(prog, ref):
    """prog, ref: {'loss': [per step], and {leaf: norm} under 'grad' (the
    first gradient), 'change' (each parameter's change), 'ema' (each EMA
    leaf's change, parameters and BN statistics) and 'bn' (each running
    statistic's change)}. Besides each worst leaf's gap: the median leaf's
    (``<name>_med``) and the worst leaf's name (``<name>_leaf``)."""
    med = statistics.median(ref['grad'].values())
    still = {k for k, g in ref['grad'].items() if g < 1e-3 * med}
    out = {'loss_gap': max(abs(a - b) / abs(b)
                           for a, b in zip(prog['loss'], ref['loss']))}
    for name, key, skip in (('grad_gap', 'grad', ()),
                            ('change_gap', 'change', still),
                            ('ema_gap', 'ema', still),
                            ('bn_gap', 'bn', ())):
        gaps = leaf_gaps(prog[key], ref[key], skip)
        worst = max(gaps, key=gaps.get)
        out[name] = gaps[worst]
        out[f'{name}_med'] = statistics.median(gaps.values())
        out[f'{name}_leaf'] = worst
    return out
