"""Exponential moving average of the params and the BN state (counterpart
of ``yolo_tpu/train/ema.py``).

The decay ramps as ``0.9999 * (1 - exp(-updates / 2000))``. The update
counter lives on the device and the blend ``d*e + (1 - d)*m`` runs as
multi-tensor ops with the decay as a device scalar, so an update queues a
handful of kernels and reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EMAState(NamedTuple):
    updates: torch.Tensor   # int32 counter, on the device
    params: dict            # {layer: {field: tensor}}
    state: dict             # BN running statistics


def _leaves(tree):
    return [t for d in tree.values() for t in d.values()]


def ema_init(params, state) -> EMAState:
    """Copies (not aliases) of ``params`` and ``state``, and a zero counter
    on their device."""
    copy = lambda tree: {k: {f: t.detach().clone() for f, t in d.items()}
                         for k, d in tree.items()}
    dev = next(iter(_leaves(params)), torch.zeros(())).device
    return EMAState(updates=torch.zeros((), dtype=torch.int32, device=dev),
                    params=copy(params), state=copy(state))


@torch.no_grad()
def ema_update(ema: EMAState, params, state, decay: float = 0.9999) -> EMAState:
    """One EMA step, in place on ``ema``'s tensors; returns ``ema``."""
    ema.updates.add_(1)
    d = decay * (1.0 - torch.exp(-ema.updates.to(torch.float32) / 2000.0))
    for e_tree, m_tree in ((ema.params, params), (ema.state, state)):
        e = [e_tree[k][f] for k, v in m_tree.items() for f in v
             if k in e_tree]
        m = [t.detach() for k, v in m_tree.items() for f, t in v.items()
             if k in e_tree]
        if e:
            torch._foreach_mul_(e, d)
            torch._foreach_add_(e, torch._foreach_mul(m, 1.0 - d))
    return ema
