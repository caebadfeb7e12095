"""Train state, the train step and the eval step.

Counterpart of ``unet_zoo_tpu/train/steps.py:33-196``. One step is the
forward in train mode, the weighted multi-output loss, the backward, a
clip of the global gradient norm to 1.0 and AdamW (weight decay 1e-5),
with optax's semantics (:class:`ClipAdamW`), then the thresholded Dice.
Every auxiliary loss that a module leaves in its training forward (the
Switch-MoE load-balancing loss of ``nn/moe.py``) joins the segmentation
loss, as JAX's step adds its ``aux_loss`` collection.
Loss and Dice stay device scalars (no ``.item()``). The step updates the
module, the optimizer and the step count in place, where the JAX step
returns a new state.

Given a ``mesh`` (``parallel/mesh.py``), each rank passes its rows of the
global batch and the steps compute what JAX's GSPMD step computes over
the whole batch: every batch statistic summed over the data group
(``parallel/global_batch.py``), the gradients averaged over it before the
clip (FSDP's come back averaged by their reduce-scatter), the loss the
global mean and Dice one ratio of the global batch.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.data.augment import random_flips, step_generator
from unet_zoo_tpu_torch.data.datasets import prepare_images, prepare_masks
from unet_zoo_tpu_torch.models import ZooModel
from unet_zoo_tpu_torch.nn.moe import aux_loss_modules, pop_aux_losses
from unet_zoo_tpu_torch.parallel.global_batch import (
    all_reduce_sum,
    global_batch_statistics,
    group_rank,
    group_size,
)
from unet_zoo_tpu_torch.parallel.mesh import data_group_of
from unet_zoo_tpu_torch.parallel.multihost import batch_rows
from unet_zoo_tpu_torch.train.losses import bce_with_logits, multi_output_loss
from unet_zoo_tpu_torch.train.metrics import dice_coefficient, dice_from_parts, dice_parts


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(lr,
    weight_decay=wd))`` over every parameter.

    Where ``torch`` differs from optax:
    - a parameter whose ``.grad`` is ``None`` (one the forward did not use,
      such as the similarity BN's bias on the K7 path) takes a zero
      gradient here, so AdamW decays it and keeps its moments from the
      first step, as optax does; ``torch.optim.AdamW`` would skip it;
    - the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
      and adds no epsilon (``torch.nn.utils.clip_grad_norm_`` divides by
      ``norm + 1e-6`` whenever ``norm > max_norm``).
    AdamW itself is ``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8,
    decoupled decay), which computes optax's ``adamw`` update. The learning
    rate can change between steps (``lr``).
    """

    def __init__(self, params: Iterable[nn.Parameter], learning_rate: float,
                 weight_decay: float = 1e-5, max_grad_norm: float = 1.0):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.adamw = torch.optim.AdamW(self.params, lr=learning_rate, betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    @property
    def lr(self) -> float:
        return self.adamw.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = float(value)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def grads(self):
        """Every parameter's gradient, zeros where the backward left none."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = self.grads()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                            self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)
        self.adamw.step()


def make_optimizer(params: Iterable[nn.Parameter], learning_rate: float,
                   weight_decay: float = 1e-5, max_grad_norm: float = 1.0) -> ClipAdamW:
    """Clip by global norm, then AdamW, with a learning rate that can change."""
    return ClipAdamW(params, learning_rate, weight_decay, max_grad_norm)


@dataclasses.dataclass
class TrainState:
    """The module being trained, its optimizer and the number of steps taken."""

    module: nn.Module
    optimizer: ClipAdamW
    step: int = 0


def create_train_state(model: ZooModel, learning_rate: float = 1e-4,
                       weight_decay: float = 1e-5, max_grad_norm: float = 1.0) -> TrainState:
    """A train state over ``model.module``'s current weights."""
    return TrainState(model.module, make_optimizer(model.module.parameters(), learning_rate,
                                                   weight_decay, max_grad_norm))


def get_lr(state: TrainState) -> float:
    return state.optimizer.lr


def set_lr(state: TrainState, lr: float) -> TrainState:
    state.optimizer.lr = lr
    return state


def mean_gradients(opt: ClipAdamW, group) -> None:
    """Average every gradient over ``group`` in place (one all-reduce of the
    gradients laid end to end). FSDP's DTensor gradients are left as they
    are: their reduce-scatter has averaged them."""
    from torch.distributed.tensor import DTensor

    grads = opt.grads()
    if group is None or any(isinstance(g, DTensor) for g in grads):
        return
    flat = torch._utils._flatten_dense_tensors(grads)
    torch.distributed.all_reduce(flat, group=group)
    flat /= group_size(group)
    for g, f in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        g.copy_(f)


def make_train_step(model: ZooModel, criterion: Callable = bce_with_logits,
                    remat: bool = False, augment: bool = False,
                    accum_steps: int = 1,
                    generator: Optional[torch.Generator] = None, mesh=None) -> Callable:
    """``step(state, images, masks) -> {'loss', 'dice'}`` (device scalars).

    ``images`` [B, C, H, W] (uint8 pixels are normalised on the device) and
    ``masks`` [B, 1, H, W] go to the module's device. ``augment=True`` flips
    the batch on the device (``data/augment.py``), drawing from a generator
    seeded from ``state.step``. ``accum_steps = k > 1`` runs k microbatches
    of B / k in turn, sums their gradients and takes one update with the
    mean; BatchNorm statistics update per microbatch, and loss and Dice are
    the microbatch means, as in the JAX step. The loss of each microbatch
    includes the auxiliary losses of its forward (:func:`pop_aux_losses`).
    ``generator``, where given, feeds the forward's dropout and stochastic
    depth (a module whose ``forward`` takes ``generator``: vnet,
    transatt_unet, swin_unet_v2, the unext family); else they draw from
    PyTorch's default generator.

    ``mesh``: a data-parallel step (module docstring). Each rank passes its
    rows of the global batch, laid out by ``parallel.multihost.batch_rows``
    for ``accum_steps`` microbatches (``shard_batch``, or
    ``prefetch_to_device(..., mesh=...)``); the flips are drawn for the
    global batch.
    """
    if remat:
        raise NotImplementedError("remat=True (recomputing the forward in the backward) is "
                                  "not ported yet (ROADMAP Queue 1 item 12)")
    module = model.module
    device = next(module.parameters()).device
    aux_modules = aux_loss_modules(module)
    forward_kw = ({"generator": generator} if generator is not None
                  and "generator" in inspect.signature(module.forward).parameters else {})

    group = data_group_of(mesh)
    world, rank = group_size(group), group_rank(group)

    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        images = prepare_images(images.to(device, non_blocking=True))
        masks = prepare_masks(masks.to(device, non_blocking=True))
        if augment:
            rows = (None if group is None
                    else batch_rows(images.shape[0] * world, accum_steps, rank, world))
            images, masks = random_flips(step_generator(state.step, device), images, masks,
                                         rows, images.shape[0] * world)
        if images.shape[0] % accum_steps:
            raise ValueError(f"batch {images.shape[0]} not divisible by accum_steps "
                             f"{accum_steps}")
        state.module.train()
        opt = state.optimizer
        opt.zero_grad()
        loss_sum = dice_sum = 0.0
        parts = []
        with global_batch_statistics(group):
            for xb, mb in zip(images.chunk(accum_steps), masks.chunk(accum_steps)):
                outputs = state.module(xb, **forward_kw)
                loss = multi_output_loss(outputs, mb, model.loss_weight, criterion)
                for aux in pop_aux_losses(aux_modules):
                    loss = loss + aux
                loss.backward()
                loss_sum = loss_sum + loss.detach()
                if group is None:
                    dice_sum = dice_sum + dice_coefficient(outputs["main"].detach(), mb)
                else:
                    parts.append(dice_parts(outputs["main"].detach(), mb))
        if accum_steps > 1:
            torch._foreach_div_(opt.grads(), float(accum_steps))
        if group is not None:
            mean_gradients(opt, group)
            sums = all_reduce_sum(torch.cat([loss_sum.reshape(1), torch.cat(parts)]), group)
            loss_sum = sums[0] / world
            dice_sum = dice_from_parts(sums[1:].reshape(-1, 2)).sum()
        opt.step()
        state.step += 1
        return {"loss": loss_sum / accum_steps, "dice": dice_sum / accum_steps}

    return step


def make_eval_step(model: ZooModel, criterion: Callable = bce_with_logits,
                   mesh=None) -> Callable:
    """``eval_step(variables, images, masks) -> {'loss', 'dice', 'main'}``:
    ``variables`` (a ``state_dict``, e.g. :func:`variables_of`, or None for
    the module's own weights) loaded into ``model.module``, which runs in
    eval mode, with no gradients. With a ``mesh`` each rank passes its rows;
    loss and Dice are the global batch's (the module docstring) and 'main'
    is this rank's rows' logits."""
    module = model.module
    device = next(module.parameters()).device
    group = data_group_of(mesh)

    @torch.no_grad()
    def eval_step(variables: Optional[Mapping[str, torch.Tensor]], images: torch.Tensor,
                  masks: torch.Tensor) -> Dict[str, Any]:
        if variables is not None:
            module.load_state_dict(variables, strict=True)
        images = prepare_images(images.to(device, non_blocking=True))
        masks = prepare_masks(masks.to(device, non_blocking=True))
        training = module.training
        module.eval()
        try:
            with global_batch_statistics(group):
                outputs = module(images)
        finally:
            module.train(training)
        loss = multi_output_loss(outputs, masks, model.loss_weight, criterion)
        if group is None:
            return {"loss": loss, "dice": dice_coefficient(outputs["main"], masks),
                    "main": outputs["main"]}
        sums = all_reduce_sum(torch.cat([loss.reshape(1), dice_parts(outputs["main"], masks)]),
                              group)
        return {"loss": sums[0] / group_size(group), "dice": dice_from_parts(sums[1:]),
                "main": outputs["main"]}

    return eval_step


def variables_of(state: TrainState) -> Dict[str, torch.Tensor]:
    """The trained weights and BatchNorm statistics (the module's
    ``state_dict``), the JAX ``{'params', 'batch_stats'}``."""
    return state.module.state_dict()
