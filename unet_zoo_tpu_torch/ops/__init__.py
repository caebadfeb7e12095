"""Tensor ops of the port (NCHW, channels_last in memory)."""

from unet_zoo_tpu_torch.ops.padding import pad_to_match
from unet_zoo_tpu_torch.ops.pooling import (adaptive_avg_pool2d, avg_pool2d, global_avg_pool,
                                            max_pool2d)
from unet_zoo_tpu_torch.ops.resize import resize_bilinear, resize_nearest, upsample2x_nearest

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "global_avg_pool", "max_pool2d", "pad_to_match",
           "resize_bilinear", "resize_nearest", "upsample2x_nearest"]
