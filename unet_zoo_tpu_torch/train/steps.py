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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.data.augment import random_flips, step_generator
from unet_zoo_tpu_torch.data.datasets import prepare_images, prepare_masks
from unet_zoo_tpu_torch.models import ZooModel
from unet_zoo_tpu_torch.nn.moe import aux_loss_modules, pop_aux_losses
from unet_zoo_tpu_torch.train.losses import bce_with_logits, multi_output_loss
from unet_zoo_tpu_torch.train.metrics import dice_coefficient


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


def make_train_step(model: ZooModel, criterion: Callable = bce_with_logits,
                    remat: bool = False, augment: bool = False,
                    accum_steps: int = 1) -> Callable:
    """``step(state, images, masks) -> {'loss', 'dice'}`` (device scalars).

    ``images`` [B, C, H, W] (uint8 pixels are normalised on the device) and
    ``masks`` [B, 1, H, W] go to the module's device. ``augment=True`` flips
    the batch on the device (``data/augment.py``), drawing from a generator
    seeded from ``state.step``. ``accum_steps = k > 1`` runs k microbatches
    of B / k in turn, sums their gradients and takes one update with the
    mean; BatchNorm statistics update per microbatch, and loss and Dice are
    the microbatch means, as in the JAX step. The loss of each microbatch
    includes the auxiliary losses of its forward (:func:`pop_aux_losses`).
    """
    if remat:
        raise NotImplementedError("remat=True (recomputing the forward in the backward) is "
                                  "not ported yet (ROADMAP Queue 1 item 12)")
    module = model.module
    device = next(module.parameters()).device
    aux_modules = aux_loss_modules(module)

    def step(state: TrainState, images: torch.Tensor, masks: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        images = prepare_images(images.to(device, non_blocking=True))
        masks = prepare_masks(masks.to(device, non_blocking=True))
        if augment:
            images, masks = random_flips(step_generator(state.step, device), images, masks)
        if images.shape[0] % accum_steps:
            raise ValueError(f"batch {images.shape[0]} not divisible by accum_steps "
                             f"{accum_steps}")
        state.module.train()
        opt = state.optimizer
        opt.zero_grad()
        loss_sum = dice_sum = 0.0
        for xb, mb in zip(images.chunk(accum_steps), masks.chunk(accum_steps)):
            outputs = state.module(xb)
            loss = multi_output_loss(outputs, mb, model.loss_weight, criterion)
            for aux in pop_aux_losses(aux_modules):
                loss = loss + aux
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            dice_sum = dice_sum + dice_coefficient(outputs["main"].detach(), mb)
        if accum_steps > 1:
            torch._foreach_div_(opt.grads(), float(accum_steps))
        opt.step()
        state.step += 1
        return {"loss": loss_sum / accum_steps, "dice": dice_sum / accum_steps}

    return step


def make_eval_step(model: ZooModel, criterion: Callable = bce_with_logits) -> Callable:
    """``eval_step(variables, images, masks) -> {'loss', 'dice', 'main'}``:
    ``variables`` (a ``state_dict``, e.g. :func:`variables_of`, or None for
    the module's own weights) loaded into ``model.module``, which runs in
    eval mode, with no gradients."""
    module = model.module
    device = next(module.parameters()).device

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
            outputs = module(images)
        finally:
            module.train(training)
        loss = multi_output_loss(outputs, masks, model.loss_weight, criterion)
        return {"loss": loss, "dice": dice_coefficient(outputs["main"], masks),
                "main": outputs["main"]}

    return eval_step


def variables_of(state: TrainState) -> Dict[str, torch.Tensor]:
    """The trained weights and BatchNorm statistics (the module's
    ``state_dict``), the JAX ``{'params', 'batch_stats'}``."""
    return state.module.state_dict()
