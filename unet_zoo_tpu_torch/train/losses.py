"""Segmentation losses: ``(logits, targets) -> scalar``, float32.

Counterpart of ``unet_zoo_tpu/train/losses.py:29-158``: BCE with logits,
soft Dice, BCE + Dice, focal and Tversky, selectable by name
(:func:`get_criterion`), and :func:`multi_output_loss`, the weighted sum
over the ``{'main', 'side*'}`` output protocol. Tensors are NCHW; every
criterion is per channel (multilabel sigmoid).

BCE is ``F.binary_cross_entropy_with_logits``, whose gradient is
sigmoid(x) - z everywhere. The JAX package writes the same value as
``max(x, 0) - x z + log1p(exp(-|x|))``, and autodiff of that form takes a
subgradient at an exactly zero logit (-z in JAX; torch's autograd of it
would give 1 - z); the derivative there is 0.5 - z.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops import resize_bilinear


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCE with logits (``torch.nn.BCEWithLogitsLoss``), float32."""
    return F.binary_cross_entropy_with_logits(logits.float(), targets.float())


def _flat_probs(logits: torch.Tensor, targets: torch.Tensor):
    """Sigmoid probabilities and targets as float32 [B, -1]."""
    p = torch.sigmoid(logits.float()).reshape(logits.shape[0], -1)
    return p, targets.float().reshape(targets.shape[0], -1)


def soft_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                   smooth: float = 1.0) -> torch.Tensor:
    """Per-sample soft Dice loss, ``1 - (2 sum(pt) + s) / (sum(p) + sum(t) + s)``, mean."""
    p, t = _flat_probs(logits, targets)
    inter = (p * t).sum(1)
    denom = p.sum(1) + t.sum(1)
    return (1.0 - (2.0 * inter + smooth) / (denom + smooth)).mean()


def bce_dice_loss(logits: torch.Tensor, targets: torch.Tensor, bce_weight: float = 0.5,
                  dice_weight: float = 0.5, smooth: float = 1.0) -> torch.Tensor:
    """Weighted BCE + soft Dice."""
    return (bce_weight * bce_with_logits(logits, targets)
            + dice_weight * soft_dice_loss(logits, targets, smooth))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.25) -> torch.Tensor:
    """Binary focal loss with logits: ``mean(w (1 - p_t)^gamma CE)`` with
    ``w = alpha z + (1 - alpha)(1 - z)``; ``alpha=None`` or negative turns
    the class weight off."""
    x, z = logits.float(), targets.float()
    ce = F.binary_cross_entropy_with_logits(x, z, reduction="none")
    mod = torch.sigmoid(torch.where(z > 0.5, -x, x)) ** gamma   # 1 - p_t
    if alpha is not None and alpha >= 0:
        mod = mod * (alpha * z + (1.0 - alpha) * (1.0 - z))
    return (mod * ce).mean()


def tversky_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.3,
                 beta: float = 0.7, smooth: float = 1.0) -> torch.Tensor:
    """Tversky loss: Dice with false positives weighted ``alpha`` and false
    negatives ``beta``."""
    p, t = _flat_probs(logits, targets)
    inter = (p * t).sum(1)
    fp = (p * (1.0 - t)).sum(1)
    fn = ((1.0 - p) * t).sum(1)
    return (1.0 - (inter + smooth) / (inter + alpha * fp + beta * fn + smooth)).mean()


CRITERIA: Dict[str, Callable] = {
    "bce": bce_with_logits,
    "bce_with_logits": bce_with_logits,
    "dice": soft_dice_loss,
    "bce_dice": bce_dice_loss,
    "combo": bce_dice_loss,
    "focal": focal_loss,
    "tversky": tversky_loss,
}


def get_criterion(name: str = "bce", **kwargs) -> Callable:
    """A criterion by its YAML name, with ``kwargs`` bound; unknown names
    and kwargs for ``bce`` raise."""
    try:
        fn = CRITERIA[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}: expected one of {sorted(CRITERIA)}")
    if kwargs:
        if fn is bce_with_logits:
            raise ValueError("loss 'bce' takes no loss_kwargs")
        return functools.partial(fn, **kwargs)
    return fn


def multi_output_loss(outputs: Dict[str, torch.Tensor], mask: torch.Tensor,
                      weight_for: Callable[[str], float],
                      criterion: Callable = bce_with_logits) -> torch.Tensor:
    """``sum_key weight_for(key) * criterion(outputs[key], mask)`` over the
    logit keys ('main' and 'side*', in sorted order); other keys are
    skipped. A side output of another size gets the mask resized to it
    (bilinear, align_corners=False)."""
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    for key in sorted(outputs):
        if key != "main" and not key.startswith("side"):
            continue
        out = outputs[key]
        m = mask
        if out.shape[-2:] != mask.shape[-2:]:
            m = resize_bilinear(mask, tuple(out.shape[-2:]), align_corners=False)
        total = total + float(weight_for(key)) * criterion(out, m)
    return total
