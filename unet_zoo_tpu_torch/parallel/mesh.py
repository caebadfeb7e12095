"""The device mesh and the layouts of the batch and the train state.

Counterpart of ``unet_zoo_tpu/parallel/mesh.py``. The mesh is a
``torch.distributed`` ``DeviceMesh`` of shape (data, model) = (N / model,
model) over the N ranks of the run (one card each); the batch is laid over
``data`` and the parameters replicated. Where JAX's ``jit`` inserts the
gradient all-reduce itself, the port's steps (``train/steps.py``) sum the
gradients and the batch statistics over the mesh's data group.

The world size is the launcher's. JAX's ``create_mesh_for_batch`` uses fewer
devices where the batch does not divide over all of them; here that would
leave ranks idle in every collective, so such a batch raises instead.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from unet_zoo_tpu_torch.parallel import multihost
from unet_zoo_tpu_torch.parallel.multihost import batch_rows


class Layout(NamedTuple):
    """A tensor's placement over the mesh's ``data`` dimension (DTensor
    placements): ``(Shard(0),)`` rows of the batch, ``(Replicate(),)`` whole
    on every rank (JAX's ``NamedSharding``)."""

    mesh: Any
    placements: tuple


def _device_type() -> str:
    """The device type ``initialize_distributed`` started the run for; a run
    it did not start names its own (nothing is guessed: a wrong guess would
    move a card's collectives to the CPU)."""
    kind = multihost._RUNTIME["device_type"]
    if kind is None:
        raise ValueError("no device type for the mesh: start the run with "
                         "parallel.initialize_distributed or pass device_type='cuda' or 'cpu'")
    return kind


def create_mesh(model_axis: int = 1, device_type: Optional[str] = None):
    """The (data, model) mesh over every rank (one card each: one process
    cannot drive another's). Without a process group (a plain
    single-process run) a group of one is started here (NCCL for
    ``device_type='cuda'``, gloo for ``'cpu'``). ``device_type`` defaults to
    the one ``initialize_distributed`` started the run for, and raises where
    there is none."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = device_type or _device_type()
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        multihost._RUNTIME["device_type"] = device_type
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} must divide device count {n}")
    ranks = torch.arange(n).reshape(n // model_axis, model_axis)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def create_mesh_for_batch(batch_size: int, max_devices: Optional[int] = None,
                          model_axis: int = 1, device_type: Optional[str] = None):
    """The (data, model) mesh over every rank, for a global batch of
    ``batch_size`` rows; raises where the data axis (the world size over
    ``model_axis``) does not divide the batch, or ``max_devices`` bounds the
    run below its world size (see the module docstring). ``device_type`` as
    :func:`create_mesh`."""
    n = multihost.process_count()
    if max_devices is not None and max_devices < n:
        raise ValueError(f"the run has {n} processes but at most {max_devices} devices were "
                         "asked for: launch as many processes as devices")
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_parallel_size={model_axis} must divide the {n} processes")
    n_data = n // model_axis
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} does not divide over the {n_data}-way data "
                         f"axis of {n} processes (ROADMAP Queue 3: the port uses every rank)")
    return create_mesh(model_axis=model_axis, device_type=device_type)


def data_group_of(mesh) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's ``data`` dimension (None: no mesh)."""
    return None if mesh is None else mesh.get_group("data")


def mesh_device(mesh) -> torch.device:
    """This rank's device: its card for a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh) -> Layout:
    """Batch dim over 'data', everything else whole."""
    from torch.distributed.tensor import Shard

    return Layout(mesh, (Shard(0),))


def replicated_sharding(mesh) -> Layout:
    from torch.distributed.tensor import Replicate

    return Layout(mesh, (Replicate(),))


def shard_batch(mesh, *arrays, microbatches: int = 1):
    """This rank's rows of each global array (tensor or numpy) on the mesh's
    device (:func:`multihost.batch_rows`); a batch that does not divide over
    the data axis raises, as JAX's ``device_put`` does."""
    group = data_group_of(mesh)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    device = mesh_device(mesh)
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % (world * microbatches):
            raise ValueError(f"a batch of shape {tuple(t.shape)} does not divide over the "
                             f"{world}-way data axis" + (f" in {microbatches} microbatches"
                                                         if microbatches > 1 else ""))
        rows = batch_rows(t.shape[0], microbatches, rank, world)
        out.append(t.index_select(0, rows).to(device))
    return out[0] if len(out) == 1 else tuple(out)


def _broadcast(tensors, group) -> None:
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        if isinstance(t, torch.Tensor):
            dist.broadcast(t.data, src=src, group=group)


def replicate_state(mesh, tree: Any) -> Any:
    """Every rank takes rank 0's values of ``tree`` (a ``TrainState``, a
    module, or a mapping of tensors), in place, so that the ranks start
    from the same weights and optimizer state; returns ``tree``."""
    group = data_group_of(mesh)
    if dist.get_world_size(group) == 1:
        return tree
    module = getattr(tree, "module", tree)
    if isinstance(module, torch.nn.Module):
        with torch.no_grad():
            _broadcast(module.state_dict().values(), group)
        opt = getattr(getattr(tree, "optimizer", None), "adamw", None)
        if opt is not None:
            for st in opt.state.values():
                _broadcast([v for v in st.values() if v.dim() > 0], group)
    else:
        with torch.no_grad():
            _broadcast(tree.values(), group)
    return tree
