"""Attention UNet: a UNet of ``depth`` levels (64 -> 64 * 2^(depth - 1)
channels) whose skip features pass additive attention gates. Counterpart of
``unet_zoo_tpu/models/attention_unet.py``; module names follow the original
zoo (``conv{i}``, ``up{i}``, ``att{i}``, ``upconv{i}``, ``conv_1x1``).

The gate is ``psi = sigmoid(BN(conv1x1(relu(BN(W_g g) + BN(W_x x))))) * x``
and the decoder concatenates ``[gated, d]``. ``depth`` is a real parameter
(the registry default is 5, the default training config trains 4). The
``ConvBlock`` and ``UpConvBlock`` convs are int8-gated: 22 at depth 5.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import ConvBlock, UpConvBlock, batch_norm, conv
from unet_zoo_tpu_torch.ops import max_pool2d


def _conv_bn(in_channels: int, out_channels: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_channels, out_channels, 1),
                         nn.BatchNorm2d(out_channels, eps=1e-5, momentum=0.1))


class AttentionBlock(nn.Module):
    """Additive attention gate on the skip feature ``x``, steered by ``g``."""

    def __init__(self, f_g: int, f_l: int, f_int: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w_g = _conv_bn(f_g, f_int)
        self.w_x = _conv_bn(f_l, f_int)
        self.psi = _conv_bn(f_int, 1)

    def _branch(self, x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
        return batch_norm(conv(x, seq[0], self.dtype), seq[1])

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = torch.relu(self._branch(g, self.w_g) + self._branch(x, self.w_x))
        return torch.sigmoid(self._branch(psi, self.psi)) * x


class AttentionUNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1, depth: int = 5,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        chans = [64 * 2 ** i for i in range(depth)]
        for i, ch in enumerate(chans):
            cin = in_channels if i == 0 else chans[i - 1]
            setattr(self, f"conv{i + 1}", ConvBlock(cin, ch, dtype, use_kernels))
        for i in range(depth - 1, 0, -1):
            ch = chans[i - 1]
            setattr(self, f"up{i + 1}", UpConvBlock(chans[i], ch, dtype, use_kernels))
            setattr(self, f"att{i + 1}", AttentionBlock(ch, ch, ch // 2, dtype))
            setattr(self, f"upconv{i + 1}", ConvBlock(2 * ch, ch, dtype, use_kernels))
        self.conv_1x1 = nn.Conv2d(chans[0], num_classes, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        h = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        skips = []
        for i in range(self.depth):
            if i > 0:
                h = max_pool2d(h, 2)
            h = getattr(self, f"conv{i + 1}")(h)
            skips.append(h)
        d = skips[-1]
        for i in range(self.depth - 1, 0, -1):
            d = getattr(self, f"up{i + 1}")(d)
            gated = getattr(self, f"att{i + 1}")(d, skips[i - 1])
            d = getattr(self, f"upconv{i + 1}")(torch.cat([gated, d], dim=1))
        return {"main": conv(d, self.conv_1x1, self.dtype)}
