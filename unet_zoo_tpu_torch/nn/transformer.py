"""Shared transformer primitives. Counterpart of
``unet_zoo_tpu/nn/transformer.py``; so far stochastic depth and dropout,
which ``swin_unet_v2`` uses.

Random draws come from an explicit ``torch.Generator`` (``None``: PyTorch's
default one), drawn on the generator's device and moved to the input's.
JAX's ``jax.random`` gives other numbers from the same seed, so tests feed
both sides the same draws.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _uniform(shape, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    device = x.device if generator is None else generator.device
    return torch.rand(shape, generator=generator, device=device).to(x.device)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in training each sample of the batch is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``
    (``floor(keep + u)``, u uniform, as the JAX package draws it); the
    identity in eval or at rate 0, where nothing is drawn."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        u = _uniform((x.shape[0],) + (1,) * (x.dim() - 1), x, generator)
        return x / keep * torch.floor(keep + u).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Element dropout as Flax's ``nn.Dropout``: keep where u < 1 - rate and
    scale by ``1 / (1 - rate)``; the identity in eval or at rate 0."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    return torch.where(_uniform(x.shape, x, generator) < keep, x / keep, torch.zeros_like(x))
