"""Classic UNet: four down and four up stages, 64 -> 1024 channels, DoubleConv
units, max-pool downsampling, transposed-conv upsampling with pad-to-match
skip concat. Counterpart of ``unet_zoo_tpu/models/unet.py``. Its 18
convolutions in DoubleConv units are int8-gated (``nn/blocks.py``);
``use_kernels`` steers K1 in the decoder and the int8 conv kernel."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import DoubleConv, DownSample, OutConv, UpSampleUNet


class UNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.down_convolution_1 = DownSample(in_channels, 64, dtype, use_kernels)
        self.down_convolution_2 = DownSample(64, 128, dtype, use_kernels)
        self.down_convolution_3 = DownSample(128, 256, dtype, use_kernels)
        self.down_convolution_4 = DownSample(256, 512, dtype, use_kernels)
        self.bottle_neck = DoubleConv(512, 1024, dtype, use_kernels)
        self.up_convolution_1 = UpSampleUNet(1024, 512, dtype, use_kernels)
        self.up_convolution_2 = UpSampleUNet(512, 256, dtype, use_kernels)
        self.up_convolution_3 = UpSampleUNet(256, 128, dtype, use_kernels)
        self.up_convolution_4 = UpSampleUNet(128, 64, dtype, use_kernels)
        self.out = OutConv(64, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        d1, p1 = self.down_convolution_1(x)
        d2, p2 = self.down_convolution_2(p1)
        d3, p3 = self.down_convolution_3(p2)
        d4, p4 = self.down_convolution_4(p3)
        b = self.bottle_neck(p4)
        u1 = self.up_convolution_1(b, d4)
        u2 = self.up_convolution_2(u1, d3)
        u3 = self.up_convolution_3(u2, d2)
        u4 = self.up_convolution_4(u3, d1)
        return {"main": self.out(u4)}
