"""Data and tensor parallelism, and spatial partitioning, over ``torch.distributed`` (counterpart of
``yolo_tpu/parallel/``): see ``mesh.py``, ``multihost.py`` and
``collectives.py``."""

from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, batch_sharding,  # noqa: F401
                   gather_state, make_mesh, replicate, replicated_sharding,
                   shard_batch, shard_spatial, shard_state,
                   spatial_sharding, state_shardings)
from .multihost import (allgather_host_values,  # noqa: F401
                        global_batch_from_host_batches, host_shard,
                        init_multihost, replicated_global)
