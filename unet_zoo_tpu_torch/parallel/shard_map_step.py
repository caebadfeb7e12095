"""A per-replica data-parallel train step: ``nn.DataParallel``'s semantics.

Counterpart of ``unet_zoo_tpu/parallel/shard_map_step.py``. Where the
default data-parallel step (``make_train_step(model, mesh=...)``) takes
every batch statistic over the global batch, as JAX's GSPMD step does, this
step runs each rank's program on its own rows alone, as JAX's ``shard_map``
step does: BatchNorm (and K7's similarity moments) over the rank's rows;
then the gradients, the loss and Dice averaged over the data group (Dice a
mean of the ranks' ratios), and the running statistics averaged after the
update. No DDP wrapper is used: its default ``broadcast_buffers`` would
overwrite every rank's running statistics with rank 0's.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from unet_zoo_tpu_torch.data.datasets import prepare_images, prepare_masks
from unet_zoo_tpu_torch.models import ZooModel
from unet_zoo_tpu_torch.nn.moe import aux_loss_modules, pop_aux_losses
from unet_zoo_tpu_torch.parallel.mesh import data_group_of
from unet_zoo_tpu_torch.train.losses import bce_with_logits, multi_output_loss
from unet_zoo_tpu_torch.train.metrics import dice_coefficient
from unet_zoo_tpu_torch.train.steps import TrainState, mean_gradients


def make_train_step_shard_map(model: ZooModel, mesh, criterion: Callable = bce_with_logits
                              ) -> Callable:
    """``step(state, images, masks) -> {'loss', 'dice'}`` on this rank's rows
    of the batch, the state replicated (``replicate_state``); see the module
    docstring."""
    group = data_group_of(mesh)
    world = dist.get_world_size(group)
    device = next(model.module.parameters()).device
    aux_modules = aux_loss_modules(model.module)

    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        images = prepare_images(images.to(device, non_blocking=True))
        masks = prepare_masks(masks.to(device, non_blocking=True))
        state.module.train()
        opt = state.optimizer
        opt.zero_grad()
        outputs = state.module(images)
        loss = multi_output_loss(outputs, masks, model.loss_weight, criterion)
        for aux in pop_aux_losses(aux_modules):
            loss = loss + aux
        loss.backward()
        mean_gradients(opt, group)
        metrics = torch.stack([loss.detach(), dice_coefficient(outputs["main"].detach(), masks)])
        dist.all_reduce(metrics, group=group)
        metrics /= world
        opt.step()
        stats = [b for n, b in state.module.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]
        if stats:
            with torch.no_grad():
                flat = torch._utils._flatten_dense_tensors(stats)
                dist.all_reduce(flat, group=group)
                flat /= world
                for b, f in zip(stats, torch._utils._unflatten_dense_tensors(flat, stats)):
                    b.copy_(f)
        state.step += 1
        return {"loss": metrics[0], "dice": metrics[1]}

    return step
