"""Move weights between the JAX package's pytrees and the port's tensors.

Both sides are ``{layer_index_str: {field: array}}`` dicts for params and
for BN state. Conv weights are HWIO in JAX and OIHW here (for a grouped
conv I = in_channels // groups on both sides, and the output channels of a
group are contiguous on both sides, so one transpose converts every group).
BN gamma/beta/mean/var, conv biases, weighted-shortcut ``w`` and SE
``fc1``/``fc2`` (already in torch ``Linear`` layout) are copied as they are.

The quantizer state (``qstate``) is a nested dict of scalars and, for a
concat, a ``float_max`` vector: ``qstate_from_jax``/``qstate_to_jax`` copy
it leaf by leaf as f32.
"""

from __future__ import annotations

import numpy as np
import torch

from .ir import NetworkIR

_CONV_KINDS = ('conv', 'depthwise')


def _conv_keys(net: NetworkIR) -> set[str]:
    return {str(l.index) for l in net.layers if l.kind in _CONV_KINDS}


def from_jax(net: NetworkIR, params, state):
    """JAX (params, state) of numpy-convertible arrays -> f32 CPU tensors."""
    convs = _conv_keys(net)

    def conv(k, f, a):
        a = np.asarray(a, np.float32)
        if k in convs and f == 'w':
            a = a.transpose(3, 2, 0, 1)                       # HWIO -> OIHW
        return torch.tensor(a)                                # a copy

    return ({k: {f: conv(k, f, a) for f, a in d.items()}
             for k, d in params.items()},
            {k: {f: conv(k, f, a) for f, a in d.items()}
             for k, d in state.items()})


def to_jax(net: NetworkIR, params, state):
    """Inverse of ``from_jax``: tensors -> numpy f32 arrays in JAX layout."""
    convs = _conv_keys(net)

    def conv(k, f, t):
        a = t.detach().to('cpu', torch.float32).numpy()
        if k in convs and f == 'w':
            a = a.transpose(2, 3, 1, 0)                       # OIHW -> HWIO
        return np.ascontiguousarray(a)

    return ({k: {f: conv(k, f, t) for f, t in d.items()}
             for k, d in params.items()},
            {k: {f: conv(k, f, t) for f, t in d.items()}
             for k, d in state.items()})


def qstate_from_jax(qstate, device=None):
    """JAX qstate (nested dicts of numpy-convertible scalars and vectors,
    e.g. 0-d arrays from a .npz) -> the same tree of f32 tensors."""
    if isinstance(qstate, dict):
        return {k: qstate_from_jax(v, device) for k, v in qstate.items()}
    return torch.tensor(np.asarray(qstate, np.float32), device=device)


def qstate_to_jax(qstate):
    """Inverse of ``qstate_from_jax``: tensors -> numpy f32 arrays."""
    if isinstance(qstate, dict):
        return {k: qstate_to_jax(v) for k, v in qstate.items()}
    return np.asarray(qstate.detach().to('cpu', torch.float32).numpy())
