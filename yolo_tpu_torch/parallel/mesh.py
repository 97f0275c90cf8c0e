"""Data parallelism over ``torch.distributed`` (counterpart of
``yolo_tpu/parallel/mesh.py``).

The JAX package runs one program on a batch sharded over a device mesh,
and XLA puts an all-reduce into every reduction over its ``data`` axis.
Here one rank is one process on one device: it holds its block of the
global batch and a full replica of the state, and the step's collectives
(``collectives.py``) make every batch-wide quantity one of the global
batch. A ``Mesh`` names this rank's place in the (data, model) grid and
the process group of its data axis; the step functions take it.

Not ported yet (see ROADMAP.md): tensor parallelism (a ``model`` axis
above 1) and spatial partitioning; they raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist

from .collectives import broadcast_tensors

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of ranks: ``shape`` maps each axis to its size,
    ``data_index`` is this rank's coordinate on the data axis,
    ``data_group`` the process group of that axis (``None`` when it has
    one rank: nothing is communicated), ``device`` this rank's device."""
    shape: dict
    data_index: int
    data_group: object
    device: torch.device


class Sharding(NamedTuple):
    """How a value lies on the mesh: ``spec`` names the axis its leading
    dimension is split over, ``()`` for a replica on every rank."""
    mesh: Mesh
    spec: tuple


def _unported(what):
    from ..compress.quant import unported
    return unported(what)


def make_mesh(device='cuda', model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh over every rank of the job (one rank outside
    a job); ``device`` is this rank's (``init_multihost`` returns it)."""
    if model_parallel != 1:
        raise _unported(f'tensor parallelism (model_parallel='
                        f'{model_parallel})')
    n = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(shape={DATA_AXIS: n, MODEL_AXIS: 1}, data_index=rank,
                data_group=dist.group.WORLD if n > 1 else None,
                device=torch.device(device))


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


def spatial_sharding(mesh: Mesh):
    raise _unported('spatial partitioning (spatial_sharding)')


def shard_spatial(mesh: Mesh, *arrays):
    raise _unported('spatial partitioning (shard_spatial)')


def state_shardings(mesh: Mesh, net, tree):
    """The ``Sharding`` of every leaf of a params-shaped tree: all
    replicated (the model axis is 1)."""
    if mesh.shape[MODEL_AXIS] > 1:
        raise _unported('tensor parallelism (state_shardings)')
    if isinstance(tree, dict):
        return {k: state_shardings(mesh, net, v) for k, v in tree.items()}
    return replicated_sharding(mesh)


def shard_state(mesh: Mesh, net, tree):
    """Lay a train state out on the mesh: with a model axis of 1, this is
    ``replicate``."""
    if mesh.shape[MODEL_AXIS] > 1:
        raise _unported('tensor parallelism (shard_state)')
    return replicate(mesh, tree)
