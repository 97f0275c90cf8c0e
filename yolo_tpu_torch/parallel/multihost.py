"""Joining the processes of one job (counterpart of
``yolo_tpu/parallel/multihost.py``).

One rank is one process on one device. ``init_multihost`` joins the job
through ``torch.distributed`` and picks the backend from the hardware:
NCCL when every rank of the host has a card of its own, gloo when the
ranks run on the CPU or outnumber the host's cards (NCCL refuses two ranks
on one card). Gloo reduces and broadcasts CUDA tensors; every other
collective of the port goes through host tensors, over a gloo group that
exists under NCCL too (``host_group``).

Data loading replaces the reference's ``DistributedSampler`` with
per-rank slicing (``host_shard``, ``DetectionDataset(process_shard=...)``).
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits for the others to join, or at a collective
TIMEOUT = timedelta(minutes=5)

# the gloo group of host values; set by init_multihost, beside
# torch.distributed's own default group
_host_group = None


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   device='cuda', timeout: timedelta = TIMEOUT
                   ) -> torch.device:
    """Join the job (call once, on every rank, before any collective) and
    return this rank's device.

    ``coordinator_address`` 'HOST:PORT' with ``num_processes`` and
    ``process_id``: rank 0 serves a TCP store there, and the ranks count
    the ranks of their host through it. ``None`` or 'auto': torchrun's
    ``env://`` variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). A rank that
    cannot reach the others raises after ``timeout``.

    ``device`` 'cuda' gives local rank r the card ``cuda:{r % cards}``;
    'cpu' runs the rank on the CPU over gloo."""
    global _host_group
    dev = torch.device(device)
    if coordinator_address in (None, '', 'auto'):
        rank = int(os.environ['RANK'])
        world = int(os.environ['WORLD_SIZE'])
        local_rank = int(os.environ.get('LOCAL_RANK', 0))
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE', 1))
        store, init_method = None, 'env://'
    else:
        if num_processes is None or process_id is None:
            raise ValueError('a coordinator address needs num_processes and '
                             'process_id')
        rank, world = int(process_id), int(num_processes)
        host, port = coordinator_address.rsplit(':', 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=timeout)
        store.set(f'host/{rank}', socket.gethostname())
        names = [store.get(f'host/{r}').decode() for r in range(world)]
        mine = [r for r in range(world) if names[r] == names[rank]]
        local_rank, local_world = mine.index(rank), len(mine)
        store, init_method = dist.PrefixStore('pg', store), None
    backend = 'gloo'
    if dev.type == 'cuda':
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError('init_multihost(device=cuda): no CUDA device')
        dev = torch.device('cuda', local_rank % cards)
        torch.cuda.set_device(dev)
        if local_world <= cards:
            backend = 'nccl'
    kw = dict(backend=backend, rank=rank, world_size=world, timeout=timeout)
    if store is not None:
        kw['store'] = store
    else:
        kw['init_method'] = init_method
    if backend == 'nccl':
        kw['device_id'] = dev
    dist.init_process_group(**kw)
    _host_group = (dist.group.WORLD if backend == 'gloo'
                   else dist.new_group(backend='gloo', timeout=timeout))
    return dev


def process_index() -> int:
    """This rank (0 outside a job), as ``jax.process_index``."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The ranks of the job (1 outside one), as ``jax.process_count``."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_group():
    """The gloo group over every rank, for host values (``None`` outside
    a job)."""
    return _host_group if dist.is_initialized() else None


def host_shard(items, *, process_index: int | None = None,
               process_count: int | None = None):
    """This rank's slice of a dataset's item list: every
    ``process_count``-th item from ``process_index`` (the reference's
    ``DistributedSampler``: disjoint, near-equal partitions)."""
    job = dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if job else 0
    if process_count is None:
        process_count = dist.get_world_size() if job else 1
    return items[process_index::process_count]


def global_batch_from_host_batches(mesh, host_batch):
    """This rank's block of the global batch on its device. In the JAX
    package the hosts' blocks are stitched into one global array; here
    each rank keeps its own block (its image indices stay local) and the
    step's collectives make every batch-wide quantity global."""
    t = torch.from_numpy(np.ascontiguousarray(host_batch))
    if mesh.device.type == 'cuda':
        return t.pin_memory().to(mesh.device, non_blocking=True)
    return t


def allgather_host_values(value):
    """Every rank's numpy ``value`` (equal shapes), stacked (pc, ...) on
    every rank, over the gloo host group."""
    a = np.array(value)            # a copy torch may write into
    group = host_group()
    if group is None:
        return a[None]
    t = torch.from_numpy(a.view(np.uint8) if a.dtype == bool else a)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    g = torch.stack(out).numpy()
    return g.view(bool) if a.dtype == bool else g


def replicated_global(mesh, value):
    """Rank 0's numpy ``value`` on every rank's device (a broadcast from
    rank 0; in the JAX package, a replicated global array)."""
    t = torch.from_numpy(np.array(value)).to(mesh.device)
    if mesh.data_group is not None:
        from .collectives import broadcast_tensors
        broadcast_tensors([t], mesh.data_group)
    return t
