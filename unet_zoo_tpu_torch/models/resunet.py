"""ResUnet: a three-down residual UNet of pre-activation ``ResidualConv``
blocks with transposed-conv upsampling. Counterpart of
``unet_zoo_tpu/models/resunet.py``; module names follow the original zoo
(``input_layer``, ``input_skip``, ``residual_conv_{1,2}``, ``bridge``,
``upsample_{1,2,3}.upsample``, ``up_residual_conv{1,2,3}``,
``output_layer``).

The stem is conv -> BN -> ReLU -> conv plus a 3x3 conv skip with no BN.
The ``ResidualConv`` convs are int8-gated, each block's 1x1 skip conv too
(stride 2 in the encoder), and ``make_predictor(quant=...)`` serves all 18
through P2.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import ResidualConv, TransposedUp, batch_norm, conv


class Upsample(nn.Module):
    """The original zoo's wrapper of the 2x2/s2 transposed conv (``upsample``)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.upsample = TransposedUp(in_channels, out_channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsample(x)


class ResUnet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 filters: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        f = list(filters)
        self.dtype = dtype
        self.input_layer = nn.Sequential(
            nn.Conv2d(in_channels, f[0], 3, padding=1),
            nn.BatchNorm2d(f[0], eps=1e-5, momentum=0.1), nn.ReLU(inplace=True),
            nn.Conv2d(f[0], f[0], 3, padding=1))
        self.input_skip = nn.Sequential(nn.Conv2d(in_channels, f[0], 3, padding=1))
        res = lambda i, o, s: ResidualConv(i, o, s, dtype, use_kernels)
        self.residual_conv_1 = res(f[0], f[1], 2)
        self.residual_conv_2 = res(f[1], f[2], 2)
        self.bridge = res(f[2], f[3], 2)
        self.upsample_1 = Upsample(f[3], f[2], dtype)
        self.up_residual_conv1 = res(2 * f[2], f[2], 1)
        self.upsample_2 = Upsample(f[2], f[1], dtype)
        self.up_residual_conv2 = res(2 * f[1], f[1], 1)
        self.upsample_3 = Upsample(f[1], f[0], dtype)
        self.up_residual_conv3 = res(2 * f[0], f[0], 1)
        self.output_layer = nn.Sequential(nn.Conv2d(f[0], max(num_classes, 1), 1))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        dt, stem = self.dtype, self.input_layer
        h = conv(torch.relu(batch_norm(conv(x, stem[0], dt), stem[1])), stem[3], dt)
        x1 = h + conv(x, self.input_skip[0], dt)
        x2 = self.residual_conv_1(x1)
        x3 = self.residual_conv_2(x2)
        x4 = self.bridge(x3)
        u = self.up_residual_conv1(torch.cat([self.upsample_1(x4), x3], dim=1))
        u = self.up_residual_conv2(torch.cat([self.upsample_2(u), x2], dim=1))
        u = self.up_residual_conv3(torch.cat([self.upsample_3(u), x1], dim=1))
        return {"main": conv(u, self.output_layer[0], dt)}
