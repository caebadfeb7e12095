"""unet_tpu: a patchify stem, stride-2 conv downsampling, nearest-2x
upsampling, and a logit head at stride 4. Counterpart of
``unet_zoo_tpu/models/unet_tpu.py`` (``UNetTPU``), same parameter names.

* stem: a 4x4/s4 VALID conv, BatchNorm, GELU (tanh form: Flax's ``nn.gelu``
  defaults to ``approximate=True``), so every later conv runs at <= 1/4 of
  the input resolution with >= ``widths[0]`` channels;
* encoder: ``DoubleConv`` per stage, then a stride-2 ``ConvNormAct``
  (padding 1); bottleneck ``DoubleConv``;
* decoder: nearest 2x, the concat ``[up, skip]``, ``DoubleConv``;
* ``head_mode='dts'`` (default): a 3x3 conv to 16 * num_classes channels at
  stride 4, depth-to-space to full-resolution logits,
  ``out[4i + a, 4j + b, c] = head[i, j, (a, b, c)]`` (the NHWC channel
  order (4, 4, nc), which is ``pixel_shuffle``'s only for one class); an
  input size the stem does not divide is restored by a bilinear resize of
  the float32 logits. ``'bilinear'``: a 1x1 conv, then a float32 bilinear
  x4 resize.

All 17 3x3 convs are int8-gated ``ConvNormAct`` convs (``nn/blocks.py``);
logits are float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import ConvNormAct, DoubleConv, batch_norm, conv
from unet_zoo_tpu_torch.ops import resize_bilinear, upsample2x_nearest

HEAD_MODES = ("dts", "bilinear")


def stem(x: torch.Tensor, conv_m: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype
         ) -> torch.Tensor:
    """The patchify stem: the 4x4/s4 conv, BatchNorm, tanh-form GELU."""
    return F.gelu(batch_norm(conv(x, conv_m, dtype), bn), approximate="tanh")


def dts_logits(hd: torch.Tensor, num_classes: int, size) -> torch.Tensor:
    """Depth-to-space of a stride-4 head [B, 16 nc, h, w] to float32 logits
    [B, nc, 4h, 4w], ``out[4i + a, 4j + b, c] = head[i, j, (a, b, c)]``,
    bilinearly resized to ``size`` where the stem did not divide it."""
    b, _, hs, ws = hd.shape
    logits = hd.reshape(b, 4, 4, num_classes, hs, ws).permute(0, 3, 4, 1, 5, 2).reshape(
        b, num_classes, 4 * hs, 4 * ws).float()
    return resize_bilinear(logits, size, align_corners=False)


class UNetTPU(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 widths: Sequence[int] = (128, 256, 512, 512), head_mode: str = "dts",
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        if head_mode not in HEAD_MODES:
            raise ValueError(f"head_mode must be one of {HEAD_MODES}, got {head_mode!r}")
        w = list(widths)
        self.dtype = dtype
        self.num_classes = num_classes
        self.head_mode = head_mode
        self.stem = nn.Conv2d(in_channels, w[0], 4, stride=4)
        self.stem_bn = nn.BatchNorm2d(w[0], eps=1e-5, momentum=0.1)
        for i in range(len(w) - 1):
            setattr(self, f"enc{i}", DoubleConv(w[i], w[i], dtype, use_kernels))
            setattr(self, f"down{i}", ConvNormAct(w[i], w[i + 1], 2, dtype, use_kernels))
        self.bottleneck = DoubleConv(w[-1], w[-1], dtype, use_kernels)
        for i in range(len(w) - 2, -1, -1):
            setattr(self, f"dec{i}", DoubleConv(w[i + 1] + w[i], w[i], dtype, use_kernels))
        if head_mode == "dts":
            self.head_dts = nn.Conv2d(w[0], 16 * num_classes, 3, padding=1)
        else:
            self.head = nn.Conv2d(w[0], num_classes, 1)
        self.depth = len(w)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': float32 logits [B, classes, H, W]}``."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        h_in, w_in = x.shape[-2:]
        h = stem(x, self.stem, self.stem_bn, self.dtype)
        skips = []
        for i in range(self.depth - 1):
            h = getattr(self, f"enc{i}")(h)
            skips.append(h)
            h = getattr(self, f"down{i}")(h)
        h = self.bottleneck(h)
        for i in range(self.depth - 2, -1, -1):
            h = torch.cat([upsample2x_nearest(h), skips[i]], dim=1)
            h = getattr(self, f"dec{i}")(h)

        if self.head_mode == "dts":
            return {"main": dts_logits(conv(h, self.head_dts, self.dtype), self.num_classes,
                                       (h_in, w_in))}
        logits = conv(h, self.head, self.dtype).float()
        return {"main": resize_bilinear(logits, (h_in, w_in), align_corners=False)}
