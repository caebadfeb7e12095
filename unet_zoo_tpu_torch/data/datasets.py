"""Batch preparation on the device (NCHW).

Counterpart of ``prepare_images`` / ``prepare_masks`` in
``unet_zoo_tpu/data/datasets.py:26-49``: the host may ship raw uint8
pixels and {0, 1} uint8 masks, and the ImageNet normalisation runs on the
device, in float32, as ``(x / 255 - mean) / std``. The datasets and the
loader are not ported yet.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """Normalise a uint8 [B, 3, H, W] batch to float32; other types pass."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    x = images.float() / 255.0
    return (x - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)


def prepare_masks(masks: torch.Tensor) -> torch.Tensor:
    """uint8 {0, 1} masks -> float32; other types pass."""
    return masks.float() if masks.dtype == torch.uint8 else masks
