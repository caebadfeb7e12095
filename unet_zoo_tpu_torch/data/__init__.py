"""Input pipeline of the port: paired image/mask datasets, the batching
loader and device feeding, on-device flips and batch preparation."""

from unet_zoo_tpu_torch.data.datasets import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    BoneDataset,
    SyntheticDataset,
    prepare_images,
    prepare_masks,
)
from unet_zoo_tpu_torch.data.loader import DataLoader, create_loader, prefetch_to_device

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "BoneDataset", "DataLoader", "SyntheticDataset",
           "create_loader", "prefetch_to_device", "prepare_images", "prepare_masks"]
