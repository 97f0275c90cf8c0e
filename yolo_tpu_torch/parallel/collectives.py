"""The collectives of the parallel step and of spatially partitioned
inference (counterpart of the collectives that XLA puts into the programs
of the JAX mesh).

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
every rank's). So is ``all_reduce_max``, the maximum of a tensor split
over a group (DoReFa's weight scale under tensor parallelism). The others
run without a gradient, but for the two of
tensor parallelism over the model group (``Mesh.model_group``), which a
sharded conv runs around itself (``models/network.py``):
``copy_to_model`` (the identity; its backward sums the input's gradient
over the group, since each rank's conv sees only its slice of the output
channels) and ``gather_channels`` (the all-gather of the ranks' channel
blocks; its backward keeps this rank's block).

Spatially partitioned inference splits the image's rows over the data
group: ``halo_rows`` hands each rank its neighbours' edge rows, and
``all_gather_dim`` joins the head maps. Both move any dtype the backend
sums, the int8 edges and heads of the int8 engine included (gloo and NCCL
sum int8 tensors).

Gloo reduces CUDA tensors for ``all_reduce`` and ``broadcast`` only. So a
gather (and a halo exchange) is an all-reduce of a zero-filled buffer of
the whole into which each rank wrote its block: the sum of one block and
zeros is that block, bit for bit, but the whole buffer crosses the wire in
both directions of the all-reduce, twice the bytes of an all-gather. NCCL
runs the same form; a dedicated ``all_gather_into_tensor`` and
point-to-point halo path waits for a run over several cards that can both
test it and measure its gain (ROADMAP.md).
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


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = x.detach().max()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        hit = x.detach() == m
        n = hit.sum().to(torch.float32)
        dist.all_reduce(n, group=group)
        ctx.save_for_backward(hit, n)
        ctx.group = group
        return m

    @staticmethod
    def backward(ctx, g):
        hit, n = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return hit.to(g.dtype) * (g / n), None


def all_reduce_max(x, group):
    """The largest element of ``x`` and of the other ranks' tensors of
    ``group``, differentiable as ``jnp.max`` of the whole: the gradient,
    summed over the group (each rank's covers the uses of the maximum in
    its own block), goes in equal shares to every element equal to the
    maximum, the ties on all ranks counted. Two collectives forward, one
    backward; without a group, ``torch.max`` (whose backward splits ties
    the same way)."""
    if group is None:
        return torch.max(x)
    return _AllReduceMax.apply(x, group)


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


def _bucketed(tensors, op):
    """Run ``op`` in place on one flattened copy of ``tensors`` per (device,
    dtype), then copy the result back into them."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        op(flat)
        with torch.no_grad():
            torch._foreach_copy_(ts, [c.view(t.shape) for c, t in
                                      zip(flat.split([t.numel() for t in ts]),
                                          ts)])


def average_tensors(tensors, group):
    """Overwrite ``tensors`` with their mean over ``group``. Every rank gets
    the same bits; over two ranks, tensors that were already equal keep
    theirs (x + x and the halving are exact)."""
    if group is None:
        return

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat /= world(group)
    _bucketed(tensors, mean)


def broadcast_tensors(tensors, group, src: int = 0):
    """Overwrite ``tensors`` with rank ``src``'s values."""
    if group is None:
        return
    src = dist.get_global_rank(group, src) \
        if group is not dist.group.WORLD else src
    _bucketed(tensors, lambda flat: dist.broadcast(flat, src=src,
                                                   group=group))


def all_gather_dim(x, dim: int, group):
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in the
    group's rank order, contiguous, without a gradient: a zero buffer of the
    whole, summed over the group (see the module docstring)."""
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.detach().contiguous()
    shape = list(x.shape)
    s = shape[dim]
    shape[dim] = s * n
    buf = x.new_zeros(shape)
    buf.narrow(dim, r * s, s).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_model(x, group):
    """The identity, whose backward sums the gradient over the model group:
    the input of a conv whose output channels are split over the group gets
    every rank's share of its gradient."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group)


def _nhwc(x):
    """An NCHW tensor's NHWC view, contiguous (free in channels_last)."""
    return x.permute(0, 2, 3, 1).contiguous()


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.c = x.shape[1]
        ctx.r = dist.get_rank(group)
        return all_gather_dim(_nhwc(x), 3, group).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.r * ctx.c, ctx.c), None


def gather_channels(x, group):
    """The NCHW tensor of the whole output channels from each rank's block
    ``x`` (channel blocks in rank order), in channels_last memory; the
    backward keeps this rank's block of the gradient."""
    if group is None:
        return x
    return _GatherChannels.apply(x, group)


def halo_rows(x, above: int, below: int, group, fill: float = 0.0):
    """The ``above`` rows over and the ``below`` rows under this rank's rows
    of an NHWC tensor whose H (dimension 1) is split over ``group`` in rank
    order: the neighbours' edge rows, or rows of ``fill`` at the image's
    top (first rank) and bottom (last rank). Returns (rows over, rows
    under), NHWC, contiguous, without a gradient, in x's dtype: an int8
    edge crosses as int8 (one rank writes each slot of the summed buffer,
    so the sum is that rank's rows, exact), and ``fill`` must then be an
    int8 code (0 for a conv's padding: every scheme the int8 engine
    serves is symmetric, so code 0 is the value 0)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    xh = x.detach().contiguous()               # (N, h, W, C)
    if max(above, below) > xh.shape[1]:
        raise ValueError(f'a halo of {max(above, below)} rows is more than '
                         f'the {xh.shape[1]} rows of a rank')
    top, bot = xh[:, :below], xh[:, xh.shape[1] - above:]

    def edge(k):
        shape = list(xh.shape)
        shape[1] = k
        return xh.new_full(shape, fill)
    shape = list(xh.shape)
    shape[1] = above + below
    buf = xh.new_zeros([n] + shape)
    buf[r, :, :above] = bot
    buf[r, :, above:] = top
    dist.all_reduce(buf, group=group)
    over = buf[r - 1, :, :above] if r > 0 else edge(above)
    under = buf[r + 1, :, above:] if r < n - 1 else edge(below)
    return over, under
