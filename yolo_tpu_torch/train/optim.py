"""Optimizers of the trainer (counterpart of ``yolo_tpu/train/optim.py``).

Parameters fall into four groups by field name (``group_label``): 'weight'
(conv kernels, the only group with weight decay), 'bias' (conv biases and
BN beta, whose burn-in lr starts at 0.1), 'other' (BN gamma, SE fc, the
weighted-shortcut ``w``) and 'scale' (quantizer scales). Each optimizer is
a ``torch.optim.Optimizer`` whose ``param_groups`` are these four groups;
the trainer sets each group's ``lr`` and ``weight_decay`` and the shared
``momentum`` before every step (``PerGroupScalars``).

The updates follow the JAX formulas term by term, not ``torch.optim.SGD``
/ ``Adam`` (whose fused forms round differently), and run as
``torch._foreach_*`` multi-tensor ops per group: yolov3 has about 225
parameter tensors, and a loop over them would queue over a thousand
kernels a step.

- SGD, nesterov: ``d = g + wd*p; v = mu*v + d; p -= lr*(d + mu*v)``.
- Adam: ``g += wd*p``; bias-corrected ``(m/bc1) / (sqrt(v/bc2) + eps)``.
- AdaBound: Adam's moments with the step size clamped into bounds that
  converge to ``final_lr``.

The optimizer state is per parameter (``momentum_buffer``; ``exp_avg``,
``exp_avg_sq``) plus, for Adam and AdaBound, one step count shared by all
groups, as JAX's single ``step``; ``state_tree``/``load_state_tree`` move
it to and from the JAX package's names (``momentum_buf``; ``step``, ``m``,
``v``) keyed like the params.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

GROUP_WEIGHT, GROUP_BIAS, GROUP_OTHER, GROUP_SCALE = 0, 1, 2, 3
GROUP_NAMES = ('weight', 'bias', 'other', 'scale')


def group_label(layer_key: str, field: str) -> int:
    """The param group of a field: conv/depthwise kernels 'w' -> weight;
    'b' and 'beta' -> bias; a field with 'scale' in its name -> scale;
    everything else (gamma, SE fc, shortcut weights) -> other."""
    if field == 'w':
        return GROUP_WEIGHT
    if field in ('b', 'beta'):
        return GROUP_BIAS
    if 'scale' in field:
        return GROUP_SCALE
    return GROUP_OTHER


def label_tree(params) -> dict:
    """An int-labelled dict congruent with ``params``."""
    return {k: {f: group_label(k, f) for f in v} for k, v in params.items()}


class PerGroupScalars(NamedTuple):
    """Per-step hyper-parameters: ``lr`` and ``weight_decay`` per group (4
    host floats), ``momentum`` shared. The values are f32-rounded, as the
    JAX package's f32 arrays hold them."""
    lr: tuple
    weight_decay: tuple
    momentum: float


def _f32(v) -> float:
    return float(np.float32(v))


class _GroupedOptimizer(torch.optim.Optimizer):
    """The four param groups of ``params`` ({layer: {field: Parameter}});
    ``keys`` keeps each parameter's (layer, field) for ``state_tree``."""

    def __init__(self, params: dict, defaults: dict):
        lbl = label_tree(params)
        groups = [{'params': [], 'keys': [], 'name': n} for n in GROUP_NAMES]
        for k, d in params.items():
            for f, p in d.items():
                g = groups[lbl[k][f]]
                g['params'].append(p)
                g['keys'].append((k, f))
        super().__init__(groups, defaults)

    def set_scalars(self, scalars: PerGroupScalars):
        """Write the step's lr, weight decay and momentum into the groups."""
        for i, g in enumerate(self.param_groups):
            g['lr'] = _f32(scalars.lr[i])
            g['weight_decay'] = _f32(scalars.weight_decay[i])
            g['momentum'] = _f32(scalars.momentum)

    def _grads(self, g):
        """(params, grads) of a group; a parameter without a gradient gets
        a zero one (the JAX tree always holds one)."""
        ps = g['params']
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        return ps, gs

    def _buffers(self, ps, name):
        out = []
        for p in ps:
            st = self.state[p]
            if name not in st:
                st[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
            out.append(st[name])
        return out

    # the JAX package's names for the state entries
    _TREE = {}

    def state_tree(self) -> dict:
        """The optimizer state as the JAX package names it, keyed like the
        params: ``{'momentum_buf': {k: {f: t}}}`` for SGD, ``{'step', 'm',
        'v'}`` for Adam and AdaBound (zeros where a parameter has no state
        yet)."""
        out = {jname: {} for jname in self._TREE}
        for g in self.param_groups:
            for p, (k, f) in zip(g['params'], g['keys']):
                for jname, name in self._TREE.items():
                    t = self.state[p].get(name)
                    out[jname].setdefault(k, {})[f] = (
                        torch.zeros_like(p) if t is None else t)
        return out

    def load_state_tree(self, tree: dict):
        """Restore ``state_tree``'s layout (tensors or arrays) into the state
        of the parameters; shapes must match."""
        for g in self.param_groups:
            for p, (k, f) in zip(g['params'], g['keys']):
                for jname, name in self._TREE.items():
                    src = torch.as_tensor(np.asarray(tree[jname][k][f]),
                                          dtype=p.dtype)
                    if src.shape != p.shape:
                        raise ValueError(f'{jname}[{k}][{f}]: shape '
                                         f'{tuple(src.shape)} != '
                                         f'{tuple(p.shape)}')
                    self.state[p][name] = src.to(p.device).clone()


class SGD(_GroupedOptimizer):
    """Nesterov SGD: ``d = g + wd*p; v = mu*v + d; p -= lr*(d + mu*v)``."""

    _TREE = {'momentum_buf': 'momentum_buffer'}

    def __init__(self, params: dict, nesterov: bool = True):
        super().__init__(params, dict(lr=0.0, weight_decay=0.0, momentum=0.0,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            if not g['params']:
                continue
            ps, gs = self._grads(g)
            vs = self._buffers(ps, 'momentum_buffer')
            lr, wd, mu = g['lr'], g['weight_decay'], g['momentum']
            d = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
            torch._foreach_mul_(vs, mu)
            torch._foreach_add_(vs, d)
            if g['nesterov']:
                step = torch._foreach_add(d, torch._foreach_mul(vs, mu))
            else:
                step = vs
            torch._foreach_sub_(ps, torch._foreach_mul(step, lr))


class Adam(_GroupedOptimizer):
    """Adam with the weight decay added to the gradient and one step count
    for every group: ``p -= lr * (m/bc1) / (sqrt(v/bc2) + eps)``."""

    _TREE = {'m': 'exp_avg', 'v': 'exp_avg_sq'}

    def __init__(self, params: dict, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=0.0, weight_decay=0.0, momentum=0.0,
                                      betas=betas, eps=eps))
        self.steps = 0

    def _bias_corrections(self):
        """(t, bc1, bc2) in f32 for the coming step."""
        b1, b2 = self.defaults['betas']
        t = np.float32(self.steps + 1)
        return (t, np.float32(1) - np.float32(b1) ** t,
                np.float32(1) - np.float32(b2) ** t)

    def _moments(self, g, ps, gs):
        """The new (m, v) of a group, in place; returns (m, v)."""
        b1, b2 = self.defaults['betas']
        ms = self._buffers(ps, 'exp_avg')
        vs = self._buffers(ps, 'exp_avg_sq')
        d = torch._foreach_add(gs, torch._foreach_mul(ps, g['weight_decay']))
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, torch._foreach_mul(d, 1 - b1))
        torch._foreach_mul_(vs, b2)
        torch._foreach_add_(vs, torch._foreach_mul(
            torch._foreach_mul(d, 1 - b2), d))
        return ms, vs

    @torch.no_grad()
    def step(self, closure=None):
        _, bc1, bc2 = self._bias_corrections()
        eps = self.defaults['eps']
        for g in self.param_groups:
            if not g['params']:
                continue
            ps, gs = self._grads(g)
            ms, vs = self._moments(g, ps, gs)
            den = torch._foreach_sqrt(torch._foreach_div(vs, float(bc2)))
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(torch._foreach_div(ms, float(bc1)), den)
            torch._foreach_sub_(ps, torch._foreach_mul(upd, g['lr']))
        self.steps += 1

    def state_tree(self) -> dict:
        out = super().state_tree()
        out['step'] = torch.tensor(self.steps, dtype=torch.int32)
        return out

    def load_state_tree(self, tree: dict):
        super().load_state_tree(tree)
        self.steps = int(np.asarray(tree['step']))


class AdaBound(Adam):
    """AdaBound: Adam's moments; the per-element step size
    ``lr*sqrt(bc2)/bc1 / (sqrt(v) + eps)`` is clamped into
    ``final_lr*lr/base_lr * [1 - 1/(gamma*t + 1), 1 + 1/(gamma*t)]``."""

    def __init__(self, params: dict, *, base_lr: float, final_lr: float = 0.1,
                 gamma: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, betas=betas, eps=eps)
        self.base_lr, self.final_lr, self.gamma = base_lr, final_lr, gamma

    @torch.no_grad()
    def step(self, closure=None):
        t, bc1, bc2 = self._bias_corrections()
        eps = self.defaults['eps']
        f = np.float32
        for g in self.param_groups:
            if not g['params']:
                continue
            ps, gs = self._grads(g)
            ms, vs = self._moments(g, ps, gs)
            lr = f(g['lr'])
            step_size = lr * np.sqrt(bc2) / bc1
            flr = f(self.final_lr) * lr / f(self.base_lr)
            lower = flr * (f(1) - f(1) / (f(self.gamma) * t + f(1)))
            upper = flr * (f(1) + f(1) / (f(self.gamma) * t))
            den = torch._foreach_sqrt(vs)
            torch._foreach_add_(den, eps)
            rate = [torch.full_like(d, float(step_size)) for d in den]
            torch._foreach_div_(rate, den)
            torch._foreach_clamp_min_(rate, float(lower))
            torch._foreach_clamp_max_(rate, float(upper))
            torch._foreach_sub_(ps, torch._foreach_mul(rate, ms))
        self.steps += 1


def make_optimizer(name: str, params: dict, *, base_lr: float | None = None):
    """'sgd', 'adam' or 'adabound' over ``params``."""
    if name == 'sgd':
        return SGD(params)
    if name == 'adam':
        return Adam(params)
    if name == 'adabound':
        if base_lr is None or not math.isfinite(base_lr):
            raise ValueError('adabound needs base_lr')
        return AdaBound(params, base_lr=base_lr)
    raise ValueError(f'unknown optimizer {name!r}')
