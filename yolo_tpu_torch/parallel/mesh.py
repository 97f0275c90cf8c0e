"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``yolo_tpu/parallel/mesh.py``).

The JAX package runs one program on a batch sharded over a device mesh,
and XLA puts an all-reduce into every reduction over its ``data`` axis.
Here one rank is one process on one device. A ``Mesh`` names this rank's
place in the (data, model) grid, laid out as JAX's ``make_mesh`` reshapes
its devices (rank r at data ``r // tp``, model ``r % tp``), and the
process groups of its two axes; the step functions take it.

- Data axis: a rank holds its block of the global batch, and the step's
  collectives (``collectives.py``) make every batch-wide quantity one of
  the global batch.
- Model axis (tensor parallelism, ``model_parallel`` > 1): the output
  channels of plain convs whose filters divide by the axis are split over
  it (``state_shardings``, JAX's rule word for word); every other tensor
  is whole on each rank. ``shard_state`` keeps this rank's block of each
  split tensor, and ``gather_state`` joins them again.
- Spatial partitioning (``shard_spatial``): an image's rows split over
  the data axis, for ``ModelBundle.make_infer(mesh=...)`` alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist

from .collectives import all_gather_dim, broadcast_tensors

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks: ``shape`` maps each axis to its size,
    ``data_index`` and ``model_index`` are this rank's coordinates,
    ``data_group`` the process group of the ranks of its model index (its
    data axis) and ``model_group`` that of the ranks of its data index
    (``None`` where an axis has one rank: nothing is communicated),
    ``device`` this rank's device."""
    shape: dict
    data_index: int
    data_group: object
    device: torch.device
    model_index: int = 0
    model_group: object = None


class Sharding(NamedTuple):
    """How a value lies on the mesh: ``spec`` names, dimension by
    dimension from the first, the axis each is split over (``None`` for
    none), as a ``PartitionSpec`` does; ``()`` is a replica on every
    rank."""
    mesh: Mesh
    spec: tuple


def make_mesh(device='cuda', model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over every rank of the job (one rank outside
    a job); ``device`` is this rank's (``init_multihost`` returns it).
    Raises ValueError when the ranks do not divide by ``model_parallel``,
    as JAX's ``make_mesh`` asserts. Every rank creates every group, in the
    same order."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    tp = int(model_parallel)
    if tp < 1 or n % tp:
        raise ValueError(f'{n} ranks do not divide by model_parallel={tp}')
    dp = n // tp
    if tp == 1:
        return Mesh(shape={DATA_AXIS: n, MODEL_AXIS: 1}, data_index=rank,
                    data_group=dist.group.WORLD if n > 1 else None,
                    device=torch.device(device))
    data_group = model_group = None
    for m in range(tp):
        ranks = list(range(m, n, tp))
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            data_group = g
    for d in range(dp):
        ranks = list(range(d * tp, (d + 1) * tp))
        g = dist.new_group(ranks)
        if rank in ranks:
            model_group = g
    return Mesh(shape={DATA_AXIS: dp, MODEL_AXIS: tp}, data_index=rank // tp,
                data_group=data_group, device=torch.device(device),
                model_index=rank % tp, model_group=model_group)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of host batches whose leading axis is the global
    batch (it must divide by the data axis)."""
    n = mesh.shape[DATA_AXIS]
    out = []
    for a in arrays:
        if len(a) % n:
            raise ValueError(f'batch of {len(a)} does not split over {n} '
                             'ranks')
        lb = len(a) // n
        out.append(a[mesh.data_index * lb:(mesh.data_index + 1) * lb])
    return tuple(out) if len(out) > 1 else out[0]


def _tensors(tree):
    """The tensors of a tree: nested dicts, lists and tuples of tensors, a
    ``torch.nn.Module`` (its parameters and buffers), or a train state (its
    model, EMA copy, optimizer state and quantizer state)."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if hasattr(tree, 'model') and hasattr(tree, 'optimizer'):
        out = _tensors(tree.model)
        if tree.ema is not None:
            out += _tensors(tree.ema.params) + _tensors(tree.ema.state)
            out.append(tree.ema.updates)
        out += [t for st in tree.optimizer.state.values()
                for t in st.values() if torch.is_tensor(t)]
        if tree.qstate is not None:
            out += _tensors(tree.qstate)
        return out
    return []


def replicate(mesh: Mesh, tree):
    """Give every rank data rank 0's values of ``tree`` (a broadcast, in
    place), so that state loaded or seeded apart starts equal; returns
    ``tree``."""
    broadcast_tensors(_tensors(tree), mesh.data_group)
    return tree


def spatial_sharding(mesh: Mesh) -> Sharding:
    """Image-HEIGHT sharding over the data axis (NHWC dimension 1):
    spatial partitioning, for low-batch serving, where every rank works on
    rows of the same image. ``ModelBundle.make_infer(mesh=...)`` exchanges
    the halo rows of each layer and gathers the head maps; its detections
    equal one process's to f32 reduction noise. H must divide by the data
    axis times the deepest stride."""
    return Sharding(mesh, (None, DATA_AXIS))


def shard_spatial(mesh: Mesh, *arrays):
    """This rank's rows of NHWC image batches (H split over the data axis,
    in rank order; a tensor comes back contiguous), for
    ``ModelBundle.make_infer(mesh=...)`` alone: the train step has no halo
    exchange, so training on such rows is not supported."""
    n = mesh.shape[DATA_AXIS]
    out = []
    for a in arrays:
        if a.shape[1] % n:
            raise ValueError(f'{a.shape[1]} rows do not split over {n} ranks')
        h = a.shape[1] // n
        if n == 1:
            out.append(a)
            continue
        a = a[:, mesh.data_index * h:(mesh.data_index + 1) * h]
        out.append(a.contiguous() if torch.is_tensor(a) else a)
    return tuple(out) if len(out) > 1 else out[0]


# ---------------------------------------------------------------------------
# tensor parallelism: conv output channels split over the model axis
# ---------------------------------------------------------------------------
# JAX's rule, word for word: only plain (groups == 1) convs whose filter
# count divides by the model axis are split (the kernel's output channels,
# dimension 0 of the port's OIHW, and the matching BN/bias vectors);
# depthwise, SE, YOLO-head convs (na*(nc+5) channels) and everything else
# stays whole on every rank.

_TP_VECTOR_FIELDS = ('gamma', 'beta', 'b', 'mean', 'var')


def _tp_spec(net, tp: int, layer_idx: int, fld: str, shape) -> tuple:
    if layer_idx >= len(net.layers):
        return ()
    lyr = net.layers[layer_idx]
    if lyr.kind != 'conv' or lyr.groups != 1 or lyr.filters % tp:
        return ()
    if fld == 'w' and len(shape) == 4 and shape[0] == lyr.filters:
        return (MODEL_AXIS,)
    if fld in _TP_VECTOR_FIELDS and tuple(shape) == (lyr.filters,):
        return (MODEL_AXIS,)
    return ()


def split_group(lyr, w, model_group):
    """``model_group`` if the weight ``w`` of the conv ``lyr`` holds a block
    of its filters (``shard_state`` split it over the group), else None:
    such a conv runs its block between ``copy_to_model`` and
    ``gather_channels``, in the float model and in the quantized sim."""
    if model_group is None or w.shape[0] == lyr.filters:
        return None
    return model_group


def state_shardings(mesh: Mesh, net, tree):
    """The ``Sharding`` of every leaf of a params-shaped tree (params, BN
    state, optimizer moments, EMA) by path pattern, as JAX's: a dict key
    that is a layer index ('12') followed by a field key ('w', 'gamma',
    ...) anywhere in the path marks a per-layer leaf; everything else is
    replicated."""
    tp = mesh.shape[MODEL_AXIS]

    def walk(t, keys):
        if isinstance(t, dict):
            return {k: walk(v, keys + (k,)) for k, v in t.items()}
        spec = ()
        if tp > 1:
            for a, b in zip(keys, keys[1:]):
                if isinstance(a, str) and a.isdigit() and isinstance(b, str):
                    spec = _tp_spec(net, tp, int(a), b, tuple(t.shape))
                    break
        return Sharding(mesh, spec)
    return walk(tree, ())


def _block(t, mesh: Mesh):
    """This rank's block of a tensor split along dimension 0 over the model
    axis."""
    return t.detach().chunk(mesh.shape[MODEL_AXIS], 0)[mesh.model_index] \
        .clone()


def _split_fields(mesh: Mesh, net, key: str, fields: dict, set_fn):
    for f, t in fields.items():
        if _tp_spec(net, mesh.shape[MODEL_AXIS], int(key), f,
                    tuple(t.shape)):
            set_fn(f, t)


def shard_state(mesh: Mesh, net, tree):
    """Lay a train state (or a params-shaped tree) out on the mesh: rank
    0's values on every rank (a broadcast over the job), then, with a model
    axis above 1, this rank's block of every split tensor, in place: the
    model's parameters and BN buffers, the EMA copy and the optimizer's
    state (built later, it comes out split too). A train state's model
    learns its model group (``Darknet.model_group``). Returns ``tree``."""
    if mesh.shape[MODEL_AXIS] == 1:
        return replicate(mesh, tree)
    broadcast_tensors(_tensors(tree), dist.group.WORLD)
    if hasattr(tree, 'model') and hasattr(tree, 'optimizer'):
        for k, m in tree.model.layer.items():
            def set_model(f, t):
                t.data = _block(t, mesh)
            _split_fields(mesh, net, k, dict(m.named_parameters(
                recurse=False)) | dict(m.named_buffers(recurse=False)),
                set_model)
        for p, st in tree.optimizer.state.items():
            for name, t in list(st.items()):
                if torch.is_tensor(t) and t.shape != p.shape:
                    st[name] = _block(t, mesh)
        if tree.ema is not None:
            _shard_dicts(mesh, net, tree.ema.params)
            _shard_dicts(mesh, net, tree.ema.state)
        tree.model.model_group = mesh.model_group
        return tree
    _shard_dicts(mesh, net, tree)
    return tree


def _shard_dicts(mesh: Mesh, net, tree: dict):
    """This rank's blocks of a {layer: {field: tensor}} tree, in place."""
    for k, d in tree.items():
        if isinstance(d, dict) and k.isdigit():
            _split_fields(mesh, net, k, dict(d),
                          lambda f, t, d=d: d.__setitem__(f, _block(t, mesh)))


def gather_state(mesh: Mesh, net, tree: dict) -> dict:
    """The whole tensors of a {layer: {field: tensor}} tree split by
    ``shard_state``: each split one all-gathered over the model group
    (every rank of the group calls this), the others as they are; a new
    tree, without a gradient."""
    if mesh is None or mesh.model_group is None:
        return tree
    tp = mesh.shape[MODEL_AXIS]
    out = {}
    for k, d in tree.items():
        out[k] = {}
        for f, t in d.items():
            whole = (t.shape[0] * tp,) + tuple(t.shape[1:]) if t.dim() \
                else ()
            if _tp_spec(net, tp, int(k), f, whole):
                t = all_gather_dim(t, 0, mesh.model_group)
            out[k][f] = t.detach()
    return out
