"""Activation functions by cfg name (counterpart of yolo_tpu/ops/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)


def relu(x):
    return F.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def hard_swish(x):
    return x * (torch.clamp(x + 3.0, 0.0, 6.0) / 6.0)


def hard_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def swish(x):
    return x * torch.sigmoid(x)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def logistic(x):
    return torch.sigmoid(x)


def linear(x):
    return x


_BY_NAME = {
    'leaky': leaky,
    'relu': relu,
    'relu6': relu6,
    'h_swish': hard_swish,
    'h_sigmoid': hard_sigmoid,
    'swish': swish,
    'mish': mish,
    'logistic': logistic,
    'linear': linear,
    # unmatched darknet names ('none', '') are the identity
    'none': linear,
    '': linear,
}


def get(name: str, maxabsscaler: bool = False):
    """Resolve an activation by cfg name; under ``maxabsscaler`` (inputs in
    (-1, 1)) the leaky slope is 0.25 instead of 0.1."""
    if name == 'leaky' and maxabsscaler:
        return lambda x: leaky(x, 0.25)
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f'Unsupported activation: {name!r}') from None
