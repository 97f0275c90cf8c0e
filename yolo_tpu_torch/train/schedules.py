"""LR schedules and the burn-in ramps (counterpart of
``yolo_tpu/train/schedules.py``).

Everything here is host arithmetic on floats, evaluated once per optimizer
step; nothing is copied to the device inside the step (a host-to-device
copy from pageable memory would synchronise the stream).
"""

from __future__ import annotations

import math

import numpy as np

from .optim import GROUP_BIAS, PerGroupScalars


def cosine_lf(epoch: float, epochs: int) -> float:
    """Cosine schedule factor ``((1 + cos(epoch*pi/epochs)) / 2)*0.95 + 0.05``."""
    return ((1 + math.cos(epoch * math.pi / epochs)) / 2) * 0.95 + 0.05


def multistep_lf(epoch: float, epochs: int, gamma: float = 0.3) -> float:
    """MultiStep factor of quantized training: ``gamma`` per milestone
    passed, at epochs // 5, epochs // 2 and epochs // 1.25."""
    milestones = [epochs // 5, epochs // 2, int(epochs // 1.25)]
    return gamma ** sum(epoch >= m for m in milestones)


def burn_in_scalars(ni: int, n_burn: int, epoch: float, *, lr0: float,
                    momentum: float, weight_decay: float, epochs: int,
                    batch_size: int, quantized: bool = False,
                    adam: bool = False) -> tuple[PerGroupScalars, float, int]:
    """(the step's optimizer scalars, the giou ratio, the accumulate count).

    Over the first ``n_burn`` batches (float training only) the bias
    group's lr falls from 0.1 and the others rise from 0 to the scheduled
    lr, the weight group's decay rises from 0, momentum goes from 0.9 to
    ``momentum``, the giou ratio from 0 to 1 and ``accumulate`` from 1 to
    64 / batch_size, all by ``np.interp``. The scalars are f32-rounded."""
    lf = (multistep_lf if quantized else cosine_lf)(epoch, epochs)
    base_lr = (lr0 * 0.005 if (adam or quantized) else lr0) * lf
    lrs = np.full(4, base_lr, np.float32)
    wds = np.zeros(4, np.float32)
    wds[0] = weight_decay
    mu = momentum
    gr = 1.0
    accumulate = max(round(64 / batch_size), 1)
    if ni <= n_burn and not quantized:
        f = ni / max(n_burn, 1)
        gr = f
        accumulate = max(1, round(np.interp(ni, [0, n_burn],
                                            [1, 64 / batch_size])))
        for g in range(4):
            start = 0.1 if g == GROUP_BIAS else 0.0
            lrs[g] = np.interp(ni, [0, n_burn], [start, base_lr])
        wds[0] = np.interp(ni, [0, n_burn], [0.0, weight_decay])
        mu = np.interp(ni, [0, n_burn], [0.9, momentum])
    return (PerGroupScalars(lr=tuple(float(v) for v in lrs),
                            weight_decay=tuple(float(v) for v in wds),
                            momentum=float(np.float32(mu))),
            float(gr), int(accumulate))
