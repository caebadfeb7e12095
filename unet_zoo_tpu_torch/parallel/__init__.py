"""Data parallelism over ``torch.distributed`` (counterpart of
``unet_zoo_tpu/parallel``): the runtime (one process a card), the mesh and
the batch and state layouts of the DataParallel and FSDP strategies, and the
global-batch statistics of their steps. The per-replica step is
``parallel.shard_map_step.make_train_step_shard_map``. The activation
layouts (spatial, pipeline) and the ``model``-axis layouts (tensor, expert)
are not ported yet (ROADMAP Queue 1 items 10b and 10c).
"""

from unet_zoo_tpu_torch.parallel.fsdp import fsdp_sharding_for, shard_state_fsdp
from unet_zoo_tpu_torch.parallel.global_batch import data_group, global_batch_statistics
from unet_zoo_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    create_mesh_for_batch,
    replicate_state,
    replicated_sharding,
    shard_batch,
)
from unet_zoo_tpu_torch.parallel.multihost import (
    fully_replicate_to_host,
    global_mesh,
    initialize_distributed,
    is_primary,
    make_global_batch,
    process_batch_slice,
    sync_global_devices,
)

__all__ = [
    "create_mesh",
    "create_mesh_for_batch",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate_state",
    "fsdp_sharding_for",
    "shard_state_fsdp",
    "initialize_distributed",
    "is_primary",
    "global_mesh",
    "process_batch_slice",
    "make_global_batch",
    "sync_global_devices",
    "fully_replicate_to_host",
    "data_group",
    "global_batch_statistics",
]
