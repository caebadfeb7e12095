"""Input handling of the port (so far only the on-device batch preparation)."""

from unet_zoo_tpu_torch.data.datasets import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    prepare_images,
    prepare_masks,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "prepare_images", "prepare_masks"]
