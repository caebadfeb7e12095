"""MultiResUNet: MultiRes blocks (a 3x3 -> 3x3 -> 3x3 chain standing in for
3x3, 5x5 and 7x7 convs, concatenated, plus a 1x1 shortcut; widths from
alpha = 1.67) and ResPaths on the skips. Counterpart of
``unet_zoo_tpu/models/multiresunet.py``; module names follow the original
zoo (``multiresblock{1-9}.conv2d_bn_{1x1,3x3,5x5,7x7}.{conv1,batchnorm}``,
``multiresblock{i}.batch_norm1``, ``respath{1-4}``, ``upsample{6-9}``,
``conv_final``).

Every BatchNorm is affine-less, and each MultiRes block applies its one
``batch_norm1`` twice (in training its running statistics move twice a
step), as the original zoo does. The conv-BN units are int8-gated, 1x1
shortcuts and the 1x1 ``conv_final`` (Co = 1) included, and
``make_predictor(quant=...)`` serves all 57 through P2.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import TransposedUp, batch_norm, conv_norm_act
from unet_zoo_tpu_torch.nn.blocks import _bn
from unet_zoo_tpu_torch.ops import max_pool2d

ALPHA = 1.67


def mrb_widths(unet_filters: int) -> Tuple[int, int, int]:
    """The 3x3, 5x5 and 7x7 branch widths of a MultiRes block."""
    w = int(unet_filters * ALPHA)
    return int(w * 0.167), int(w * 0.333), int(w * 0.5)


class Conv2dBatchnorm(nn.Module):
    """A kxk conv (padded to keep the size) -> affine-less BN -> ``act``
    (:func:`conv_norm_act`), as the original zoo's ``Conv2d_batchnorm``
    names it (``conv1``, ``batchnorm``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 act: Optional[str], dtype: torch.dtype, use_kernels: Optional[bool]):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.act = act
        self.conv1 = nn.Conv2d(in_channels, out_channels, kernel_size,
                               padding=kernel_size // 2)
        self.batchnorm = _bn(out_channels, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_norm_act(x, self.conv1, self.batchnorm, self.dtype, self.use_kernels,
                             self.act)


class MultiResBlock(nn.Module):
    def __init__(self, in_channels: int, unet_filters: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        f3, f5, f7 = mrb_widths(unet_filters)
        args = (dtype, use_kernels)
        self.conv2d_bn_1x1 = Conv2dBatchnorm(in_channels, f3 + f5 + f7, 1, None, *args)
        self.conv2d_bn_3x3 = Conv2dBatchnorm(in_channels, f3, 3, "relu", *args)
        self.conv2d_bn_5x5 = Conv2dBatchnorm(f3, f5, 3, "relu", *args)
        self.conv2d_bn_7x7 = Conv2dBatchnorm(f5, f7, 3, "relu", *args)
        self.batch_norm1 = _bn(f3 + f5 + f7, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.conv2d_bn_1x1(x)
        a = self.conv2d_bn_3x3(x)
        b = self.conv2d_bn_5x5(a)
        c = self.conv2d_bn_7x7(b)
        h = batch_norm(torch.cat([a, b, c], dim=1), self.batch_norm1)
        return batch_norm(torch.relu(h + shortcut), self.batch_norm1)


class ResPath(nn.Module):
    """``length`` residual units on a skip: relu(3x3 conv-BN-ReLU + 1x1
    conv-BN), then an affine-less BN."""

    def __init__(self, in_channels: int, filters: int, length: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        args = (dtype, use_kernels)
        self.conv2d_bn_1x1_initial = Conv2dBatchnorm(in_channels, filters, 1, None, *args)
        self.conv2d_bn_3x3_initial = Conv2dBatchnorm(in_channels, filters, 3, "relu", *args)
        self.batch_norm_initial = _bn(filters, affine=False)
        self.blocks = nn.ModuleList(nn.Sequential(
            Conv2dBatchnorm(filters, filters, 1, None, *args),
            Conv2dBatchnorm(filters, filters, 3, "relu", *args),
            _bn(filters, affine=False)) for _ in range(length - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv2d_bn_3x3_initial(x) + self.conv2d_bn_1x1_initial(x))
        h = batch_norm(h, self.batch_norm_initial)
        for shortcut, conv3, bn in self.blocks:
            h = batch_norm(torch.relu(conv3(h) + shortcut(h)), bn)
        return h


class MultiResUnet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1, filters: int = 32,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        f = filters
        args = (dtype, use_kernels)
        cin = in_channels
        for i, (mult, path_len) in enumerate(zip((1, 2, 4, 8), (4, 3, 2, 1))):
            setattr(self, f"multiresblock{i + 1}", MultiResBlock(cin, f * mult, *args))
            cin = sum(mrb_widths(f * mult))
            setattr(self, f"respath{i + 1}", ResPath(cin, f * mult, path_len, *args))
        self.multiresblock5 = MultiResBlock(cin, f * 16, *args)
        cin = sum(mrb_widths(f * 16))
        for i, mult in enumerate((8, 4, 2, 1)):
            setattr(self, f"upsample{6 + i}", TransposedUp(cin, f * mult, dtype))
            setattr(self, f"multiresblock{6 + i}", MultiResBlock(2 * f * mult, f * mult, *args))
            cin = sum(mrb_widths(f * mult))
        self.conv_final = Conv2dBatchnorm(cin, num_classes, 1, None, *args)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        h = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        skips = []
        for i in range(1, 5):
            h = getattr(self, f"multiresblock{i}")(h)
            skips.append(getattr(self, f"respath{i}")(h))
            h = max_pool2d(h, 2)
        h = self.multiresblock5(h)
        for i in range(6, 10):
            up = getattr(self, f"upsample{i}")(h)
            h = getattr(self, f"multiresblock{i}")(torch.cat([up, skips[9 - i]], dim=1))
        return {"main": self.conv_final(h)}
