"""The multi-process runtime: one process a card, started by a launcher.

Counterpart of ``unet_zoo_tpu/parallel/multihost.py``. JAX drives every
device of a host from one process and puts all of them in one global mesh.
PyTorch runs one process per card (``torchrun --nproc-per-node N``): each
rank runs the same program on its rows of the same global batch, and the
collectives run over NCCL where the device is CUDA, over gloo only where the
caller asks for the CPU (or names the backend). Nothing falls back from
NCCL to gloo, or from the card to the CPU.

A plain single-process run needs no set-up: every helper answers for a
world of one, so the train CLI calls them unconditionally.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

# the device type the runtime was started for ("cuda" or "cpu"); read by mesh.py
_RUNTIME = {"device_type": None}


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, local_rank: Optional[int] = None,
                           backend: Optional[str] = None, device: str = "cuda") -> bool:
    """Join the process group of a multi-process run.

    Arguments default to the launcher's environment (``torchrun`` sets
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
    ``MASTER_PORT``; ``init_method`` then defaults to ``env://``). Returns
    False for a plain single-process run (no world size given or set), True
    once the group is up (also when it already was). ``device='cuda'`` binds
    this rank's card by ``LOCAL_RANK`` and uses NCCL; ``device='cpu'`` uses
    gloo. ``backend`` overrides that choice (gloo collectives also take CUDA
    tensors, so several ranks may share one card for a test).
    """
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if dist.is_initialized():
        _RUNTIME["device_type"] = _RUNTIME["device_type"] or device
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if world_size is None:
        return False
    if rank is None:
        rank = int(env.get("RANK", 0))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): CUDA is not available; "
                               "pass device='cpu' to run the ranks on the CPU over gloo")
        if not 0 <= local_rank < torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {local_rank} has no card: this host has "
                             f"{torch.cuda.device_count()}; launch one process a card")
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _RUNTIME["device_type"] = device
    return True


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that writes logs, events and checkpoints."""
    return process_index() == 0


def global_mesh(model_axis: int = 1):
    """The (data, model) mesh over every rank (``mesh.create_mesh``)."""
    from unet_zoo_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(model_axis=model_axis)


def process_batch_slice(global_batch_size: int) -> Tuple[int, int]:
    """This process's ``[start, stop)`` rows of a global batch: rank r holds
    rows ``[r B / N, (r + 1) B / N)``, as JAX lays a batch over the data axis."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    per = global_batch_size // n
    start = process_index() * per
    return start, start + per


def batch_rows(global_batch_size: int, microbatches: int = 1, rank: Optional[int] = None,
               world: Optional[int] = None) -> torch.Tensor:
    """The global rows rank ``rank`` of ``world`` holds, in order, for a step
    of ``microbatches`` microbatches: JAX's microbatch i is rows
    ``[i B / k, (i + 1) B / k)`` of the global batch, laid over the data axis
    in turn, so the rank holds each microbatch's r-th share, microbatch by
    microbatch (one microbatch: :func:`process_batch_slice`)."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    k = microbatches
    if global_batch_size % (world * k):
        raise ValueError(f"a global batch of {global_batch_size} rows does not divide over "
                         f"the {world}-way data axis" + (f" in {k} microbatches" if k > 1 else ""))
    per, micro = global_batch_size // (world * k), global_batch_size // k
    return torch.cat([torch.arange(i * micro + rank * per, i * micro + (rank + 1) * per)
                      for i in range(k)])


def make_global_batch(mesh, *host_shards):
    """This process's shards (its rows of the global batch, e.g.
    :func:`process_batch_slice`) on the mesh's device: a rank's part of the
    global batch is what the port's steps take (JAX assembles a global
    array from the same shards)."""
    from unet_zoo_tpu_torch.parallel.mesh import mesh_device

    device = mesh_device(mesh)
    out = tuple(torch.as_tensor(a).to(device) for a in host_shards)
    return out[0] if len(out) == 1 else out


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier over every rank (e.g. before reading a checkpoint another
    process just wrote); nothing in a single-process run."""
    if process_count() > 1:
        dist.barrier()


def _gather_rows(t) -> torch.Tensor:
    """A DTensor laid by rows of its first dimension over a 1-D mesh (FSDP's
    layout) or replicated, whole: each rank's rows padded to the largest
    share, one ``all_gather_into_tensor`` of the group, the padding cut.
    (gloo's functional all-gather, which ``DTensor.full_tensor`` takes,
    crashes on CUDA tensors; this call does not.)"""
    from torch.distributed.tensor import Replicate, Shard

    if all(isinstance(pl, Replicate) for pl in t.placements):
        return t.to_local()
    if t.device_mesh.ndim != 1 or tuple(t.placements) != (Shard(0),):
        raise ValueError(f"a DTensor laid out {t.placements} over a {t.device_mesh.ndim}-D mesh: "
                         "only FSDP's rows are gathered")
    group = t.device_mesh.get_group()
    n = dist.get_world_size(group)
    local = t.to_local().detach()
    per = -(-t.shape[0] // n)
    buf = local.new_zeros((per,) + tuple(t.shape[1:]))
    buf[:local.shape[0]] = local
    out = local.new_empty((per * n,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, buf.contiguous(), group=group)
    return out[:t.shape[0]]


def fully_replicate_to_host(tree: Any) -> Any:
    """``tree`` with every tensor on the host, sharded ones (FSDP's DTensors)
    gathered whole: a collective, so every rank calls it."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return _gather_rows(tree).detach().cpu()
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return type(tree)((k, fully_replicate_to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(fully_replicate_to_host(v) for v in tree)
    return tree
