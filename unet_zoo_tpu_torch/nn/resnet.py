"""ResNet-34 encoder (NCHW) for RAUNet.

Counterpart of ``unet_zoo_tpu/nn/resnet.py``: torchvision's ``resnet34``
without its pooling head. Module names are the ones RAUNet gives the
torchvision modules it borrows in the original zoo: ``firstconv``,
``firstbn``, ``encoder{1-4}.{i}.{conv,bn}{1,2}`` and
``encoder{2-4}.0.downsample.{0,1}``. The convs are plain (not int8-gated),
as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from unet_zoo_tpu_torch.nn.blocks import _bn, batch_norm, conv
from unet_zoo_tpu_torch.ops import max_pool2d

# (blocks, width, stride of the first block) of layer1..layer4
LAYERS = ((3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2))


class BasicBlock(nn.Module):
    """torchvision's ``BasicBlock``: conv3x3(stride) -> BN -> ReLU ->
    conv3x3 -> BN, plus the input (through a 1x1 conv(stride) and BN where
    the shape changes), then ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = _bn(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False)
        self.bn2 = _bn(out_channels)
        if stride != 1 or in_channels != out_channels:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False),
                _bn(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.relu(batch_norm(conv(x, self.conv1, dt), self.bn1))
        h = batch_norm(conv(h, self.conv2, dt), self.bn2)
        if hasattr(self, "downsample"):
            x = batch_norm(conv(x, self.downsample[0], dt), self.downsample[1])
        return torch.relu(h + x)


class ResNet34Encoder(nn.Module):
    """The stem (conv7x7/2 -> BN -> ReLU -> max pool 3x3/2 with -inf
    padding) and layer1..layer4 (``encoder1..4``); :meth:`encode` returns
    their four outputs at strides 4, 8, 16 and 32."""

    def __init__(self, in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.firstconv = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.firstbn = _bn(64)
        cin = 64
        for li, (blocks, width, stride) in enumerate(LAYERS):
            setattr(self, f"encoder{li + 1}", nn.Sequential(*(
                BasicBlock(cin if bi == 0 else width, width, stride if bi == 0 else 1, dtype)
                for bi in range(blocks))))
            cin = width

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h = torch.relu(batch_norm(conv(x, self.firstconv, self.dtype), self.firstbn))
        h = max_pool2d(h, 3, 2, padding=1)
        feats = []
        for li in range(len(LAYERS)):
            h = getattr(self, f"encoder{li + 1}")(h)
            feats.append(h)
        return tuple(feats)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.encode(x)
