"""u2net_tpu: U²-Net's ideas (nested mini-U stages, side supervision, a fused
output) on ``unet_tpu``'s layout. Counterpart of
``unet_zoo_tpu/models/u2net_tpu.py`` (``U2NetTPU``), same parameter names.

* the 4x4/s4 patchify stem of ``unet_tpu`` (conv, BN, tanh-form GELU);
* three encoder stages at strides 4, 8, 16, each an ``RSUTPU`` (an in-conv,
  ``levels`` stride-2 descents, nearest-2x ascents with additive skips, an
  input residual) and a stride-2 ``ConvNormAct``; a ``DilatedBlock``
  bottleneck at stride 32 (dilations 1, 2, 4, an input residual);
* three decoder stages: nearest 2x, the concat ``[up, skip]``, an ``RSUTPU``;
* side heads at strides 32, 16, 8: a 1x1 conv, then in float32 a bilinear
  resize to the input; at stride 4 the ``dts`` head of ``unet_tpu`` (a 3x3
  conv to 16 nc channels and depth-to-space) or, with ``head_mode
  'bilinear'``, a 1x1 conv resized like the others; ``outconv`` fuses the
  four in float32.

Outputs ``{'main', 'side1'..'side4'}``, float32, at unit loss weights. Every
``ConvNormAct`` conv is int8-gated, and ``make_predictor(quant=...)`` serves
all 43 through P2, the bottleneck's dilated ones (2, 4, 8) included.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from unet_zoo_tpu_torch.models.unet_tpu import HEAD_MODES, dts_logits, stem
from unet_zoo_tpu_torch.nn import ConvNormAct, conv
from unet_zoo_tpu_torch.ops import resize_bilinear, upsample2x_nearest


class RSUTPU(nn.Module):
    """A mini-U block at constant ``width`` (module docstring)."""

    def __init__(self, in_channels: int, width: int, levels: int = 2,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.levels = levels
        cna = lambda cin, stride=1: ConvNormAct(cin, width, stride, dtype, use_kernels)
        self.conv_in = cna(in_channels)
        for i in range(levels):
            setattr(self, f"down{i}", cna(width, 2))
            setattr(self, f"enc{i}", cna(width))
        for i in range(levels - 1, -1, -1):
            setattr(self, f"dec{i}", cna(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hin = self.conv_in(x)
        enc, h = [hin], hin
        for i in range(self.levels):
            h = getattr(self, f"enc{i}")(getattr(self, f"down{i}")(h))
            enc.append(h)
        for i in range(self.levels - 1, -1, -1):
            h = getattr(self, f"dec{i}")(upsample2x_nearest(h) + enc[i])
        return h + hin


class DilatedBlock(nn.Module):
    """The bottleneck: an in-conv, then dilations 1, 2, 4, plus the in-conv's output."""

    def __init__(self, in_channels: int, width: int, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.conv_in = ConvNormAct(in_channels, width, 1, dtype, use_kernels)
        for i, dil in enumerate((1, 2, 4)):
            setattr(self, f"dil{i}", ConvNormAct(width, width, 1, dtype, use_kernels,
                                                 dilation=dil))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hin = self.conv_in(x)
        return self.dil2(self.dil1(self.dil0(hin))) + hin


class U2NetTPU(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 widths: Sequence[int] = (128, 256, 512, 512),
                 levels: Sequence[int] = (2, 2, 1), head_mode: str = "dts",
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        if head_mode not in HEAD_MODES:
            raise ValueError(f"head_mode must be one of {HEAD_MODES}, got {head_mode!r}")
        w, lv = list(widths), list(levels)
        self.dtype = dtype
        self.num_classes = num_classes
        self.head_mode = head_mode
        self.stem = nn.Conv2d(in_channels, w[0], 4, stride=4)
        self.stem_bn = nn.BatchNorm2d(w[0], eps=1e-5, momentum=0.1)
        for i in range(3):
            setattr(self, f"enc{i}", RSUTPU(w[i], w[i], lv[i], dtype, use_kernels))
            setattr(self, f"down{i}", ConvNormAct(w[i], w[i + 1], 2, dtype, use_kernels))
        self.bottleneck = DilatedBlock(w[3], w[3], dtype, use_kernels)
        for i in range(2, -1, -1):
            setattr(self, f"dec{i}", RSUTPU(w[i + 1] + w[i], w[i], lv[i], dtype, use_kernels))
        self.side4 = nn.Conv2d(w[3], num_classes, 1)
        self.side3 = nn.Conv2d(w[2], num_classes, 1)
        self.side2 = nn.Conv2d(w[1], num_classes, 1)
        if head_mode == "dts":
            self.side1_dts = nn.Conv2d(w[0], 16 * num_classes, 3, padding=1)
        else:
            self.side1 = nn.Conv2d(w[0], num_classes, 1)
        self.outconv = nn.Conv2d(4 * num_classes, num_classes, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main', 'side1'..'side4'}``, float32
        logits [B, classes, H, W]."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        size = tuple(x.shape[-2:])
        h = stem(x, self.stem, self.stem_bn, self.dtype)
        skips = []
        for i in range(3):
            h = getattr(self, f"enc{i}")(h)
            skips.append(h)
            h = getattr(self, f"down{i}")(h)
        bott = h = self.bottleneck(h)
        decs = []                                    # strides 16, 8, 4
        for i in range(2, -1, -1):
            h = getattr(self, f"dec{i}")(torch.cat([upsample2x_nearest(h), skips[i]], dim=1))
            decs.append(h)

        def side(feat, head):
            return resize_bilinear(conv(feat, head, self.dtype).float(), size,
                                   align_corners=False)

        if self.head_mode == "dts":
            side1 = dts_logits(conv(decs[2], self.side1_dts, self.dtype), self.num_classes, size)
        else:
            side1 = side(decs[2], self.side1)
        sides = [side1, side(decs[1], self.side2), side(decs[0], self.side3),
                 side(bott, self.side4)]
        out = {"main": conv(torch.cat(sides, dim=1), self.outconv, torch.float32)}
        out.update((f"side{i + 1}", s) for i, s in enumerate(sides))
        return out
