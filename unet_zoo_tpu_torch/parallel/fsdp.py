"""FSDP: parameters and AdamW moments sharded over the mesh's data axis
(ZeRO-3). Counterpart of ``unet_zoo_tpu/parallel/fsdp.py``.

The module is wrapped by FSDP2's ``fully_shard`` over the ``data``
dimension: each parameter becomes a DTensor holding rows ``[r d0 / N, (r +
1) d0 / N)`` of its first dimension on rank r (padded where N does not
divide d0), gathered whole for the forward and the backward, and its
gradient comes back reduce-scattered, averaged over the ranks. JAX shards
each leaf on its largest divisible axis instead; either layout computes the
same step, which is the data-parallel one (``train/steps.py``): the batch
statistics are global and the clip sees the global norm (``torch._foreach_norm``
over DTensor gradients returns it on every rank). Buffers (BatchNorm's
running statistics) stay whole on every rank. FSDP2 takes contiguous
parameters only, so the convs' channels_last weights are made contiguous
first (the same values; the gathered weights are contiguous too).

Usage::

    mesh = create_mesh()
    state = shard_state_fsdp(mesh, state)      # instead of replicate_state
    imgs, masks = shard_batch(mesh, imgs, masks)
    metrics = make_train_step(model, mesh=mesh)(state, imgs, masks)
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from unet_zoo_tpu_torch.parallel.mesh import Layout, batch_sharding, replicated_sharding


def fsdp_sharding_for(mesh, tree: Any) -> Dict[str, Layout]:
    """The layout of each tensor of ``tree`` (a module or a ``state_dict``)
    under :func:`shard_state_fsdp`: parameters (floating tensors other than
    running statistics) by rows of their first dimension, the rest whole."""
    if isinstance(tree, torch.nn.Module):
        params = {n for n, _ in tree.named_parameters()}
        tree = tree.state_dict()
    else:
        params = {n for n, t in tree.items() if t.is_floating_point() and "running_" not in n}
    return {n: batch_sharding(mesh) if n in params else replicated_sharding(mesh) for n in tree}


def _shard_like(full: torch.Tensor, like) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device_mesh.device_type), like.device_mesh,
                             like.placements)


def shard_state_fsdp(mesh, state):
    """Shard a ``TrainState``'s module and optimizer over the mesh's data
    axis, in place; returns ``state``. Weights and moments come from the
    state as it is (every rank must hold the same: a new model from one seed,
    or a restored checkpoint)."""
    from torch.distributed.fsdp import fully_shard

    from unet_zoo_tpu_torch.train.steps import ClipAdamW

    old = state.optimizer
    saved = old.adamw.state_dict()
    group = old.adamw.param_groups[0]
    with torch.no_grad():
        for p in state.module.parameters():
            p.data = p.data.contiguous()   # FSDP2 shards contiguous rows, not channels_last
    fully_shard(state.module, mesh=mesh["data"])
    new = ClipAdamW(state.module.parameters(), group["lr"], group["weight_decay"],
                    old.max_grad_norm)
    # each AdamW moment cut as its parameter is (the step counts stay whole)
    moments = {i: {k: _shard_like(v, new.params[i]) if v.dim() else v for k, v in st.items()}
               for i, st in saved["state"].items()}
    new.adamw.load_state_dict({"state": moments, "param_groups": saved["param_groups"]})
    state.optimizer = new
    return state


def sharded_bytes(state) -> Dict[str, int]:
    """Bytes this rank holds of the parameters and of AdamW's two moments."""
    from torch.distributed.tensor import DTensor

    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    params = sum(local(p).numel() * p.element_size() for p in state.module.parameters())
    moments = sum(local(v).numel() * v.element_size()
                  for st in state.optimizer.adamw.state.values()
                  for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
    return {"params": params, "moments": moments}
