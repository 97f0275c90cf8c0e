"""Move weights between the JAX package's pytrees and the port's tensors.

Both sides are ``{layer_index_str: {field: array}}`` dicts for params and
for BN state. Conv weights are HWIO in JAX and OIHW here (for a grouped
conv I = in_channels // groups on both sides, and the output channels of a
group are contiguous on both sides, so one transpose converts every group).
BN gamma/beta/mean/var, conv biases, weighted-shortcut ``w``, SE
``fc1``/``fc2`` (already in torch ``Linear`` layout) and TPSQ's 0-d
``w_scale``/``b_scale``/``a_scale`` params are copied as they are.

The quantizer state (``qstate``) of every scheme is a nested dict of
scalars and vectors (a concat's ``float_max``, cos-PTQ's ``votes``):
``qstate_from_jax``/``qstate_to_jax`` copy it leaf by leaf as f32.

The optimizer state (``opt_state_from_jax``/``opt_state_to_jax``) holds
params-shaped trees under the JAX package's names, ``momentum_buf`` (SGD)
or ``m`` and ``v`` with a ``step`` count (Adam, AdaBound), converted as
the params are. The EMA pair is a (params, state) pair: ``from_jax`` and
``to_jax`` carry it.
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
        # (np.ascontiguousarray would make a 0-d scale 1-d)
        return a if a.flags.c_contiguous else np.ascontiguousarray(a)

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


# the fields of the JAX package's optimizer-state NamedTuples, in order: a
# checkpoint it writes holds them as a list
_OPT_FIELDS = {1: ('momentum_buf',), 3: ('step', 'm', 'v')}


def opt_state_from_jax(net: NetworkIR, opt_state):
    """JAX optimizer state -> ``{'momentum_buf': tree}`` or ``{'step': int,
    'm': tree, 'v': tree}`` of f32 CPU tensors in the port's layout. Takes
    the NamedTuple, a dict of its fields, or the positional list that a
    JAX checkpoint holds."""
    if hasattr(opt_state, '_fields'):
        opt_state = opt_state._asdict()
    elif isinstance(opt_state, (list, tuple)):
        opt_state = dict(zip(_OPT_FIELDS[len(opt_state)], opt_state))
    out = {}
    for name, tree in opt_state.items():
        out[name] = (int(np.asarray(tree)) if name == 'step'
                     else from_jax(net, tree, {})[0])
    return out


def opt_state_to_jax(net: NetworkIR, opt_state):
    """Inverse of ``opt_state_from_jax``: the port optimizer's
    ``state_tree()`` -> a dict of the JAX field names with numpy trees in
    the JAX layout (``step`` an int32 array)."""
    out = {}
    for name, tree in opt_state.items():
        out[name] = (np.asarray(int(tree), np.int32) if name == 'step'
                     else to_jax(net, tree, {})[0])
    return out
