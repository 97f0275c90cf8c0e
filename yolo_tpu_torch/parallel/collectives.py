"""The collectives of the data-parallel step (counterpart of the all-reduces
that XLA puts into every reduction over the JAX mesh's ``data`` axis).

A rank holds its block of the global batch, so every batch-wide quantity
of a step is a sum over ranks: the train-mode BN statistics, the loss's
normalisers, the QAT range trackers, the KD terms' counts and, after the
backward, the gradients. Each function here takes the data group
(``Mesh.data_group``); ``None`` stands for one process, communicates
nothing and returns its input, so the single-process path runs the same
operations as before.

``all_reduce`` is differentiable: its backward is an all-reduce of the
gradient (rank r's loss depends on the other ranks' activations through
the shared statistic, so the gradient of that statistic is the sum of
every rank's). The others run without a gradient. Gloo reduces CUDA
tensors for ``all_reduce`` and ``broadcast`` only; nothing here uses
another collective on a device tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world(group) -> int:
    """The number of ranks in ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x, group):
    """The sum of ``x`` over the ranks of ``group``, differentiable."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


_OPS = {'sum': dist.ReduceOp.SUM, 'min': dist.ReduceOp.MIN,
        'max': dist.ReduceOp.MAX}


def all_reduce_nograd(x, group, op: str = 'sum'):
    """``x`` reduced by ``op`` ('sum', 'min', 'max') over ``group``, as a
    new tensor without a gradient."""
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y


def batch_moments(x, dims, group, one_pass: bool):
    """(mean, biased variance, count) of ``x`` over ``dims`` and the ranks
    of ``group``, differentiable. Two-pass (the sum, then the squared
    deviations from the global mean: two collectives) unless ``one_pass``
    (the sums of x and x^2 in one collective, then ``E[x^2] - mean^2``
    clamped at 0)."""
    n = world(group)
    for d in dims:
        n *= x.shape[d]
    if one_pass:
        s = all_reduce(torch.stack([x.sum(dims), x.square().sum(dims)]),
                       group) / n
        return s[0], torch.clamp_min(s[1] - s[0].square(), 0.0), n
    mean = all_reduce(x.sum(dims), group) / n
    shape = [1] * x.dim()
    for d in range(x.dim()):
        if d not in dims:
            shape[d] = x.shape[d]
    var = all_reduce((x - mean.reshape(shape)).square().sum(dims), group) / n
    return mean, var, n


def sum_gradients(params, group):
    """Sum the ``.grad`` of ``params`` over ``group`` in one flattened
    bucket (a parameter without one gets zeros first, as the optimizers
    read it)."""
    if group is None:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    sizes = [g.numel() for g in grads]
    torch._foreach_copy_(grads, [c.view(g.shape) for c, g in
                                 zip(flat.split(sizes), grads)])


def broadcast_tensors(tensors, group, src: int = 0):
    """Overwrite ``tensors`` with rank ``src``'s values, one flattened
    bucket per (device, dtype)."""
    if group is None:
        return
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    src = dist.get_global_rank(group, src) \
        if group is not dist.group.WORLD else src
    for ts in buckets.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        with torch.no_grad():
            torch._foreach_copy_(ts, [c.view(t.shape) for c, t in
                                      zip(flat.split([t.numel() for t in ts]),
                                          ts)])
