"""UNet++ (NestedUNet): dense nested skip pathways over 15 ``DoubleConvMid``
cells of widths (32, 64, 128, 256, 512), bilinear 2x upsampling with
``align_corners=True``, and optional deep supervision. Counterpart of
``unet_zoo_tpu/models/nested_unet.py``; module names follow the original
zoo (``conv{r}_{c}``, ``final`` or ``final1..4``).

Outputs ``{'main': final}``; with ``deep_supervision`` ``{'main': final4,
'side1'..'side3': final1..3}``, the sides at the registry's default loss
weight (0.5). All 30 cell convs are int8-gated.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import DoubleConvMid, conv
from unet_zoo_tpu_torch.ops import max_pool2d, resize_bilinear

WIDTHS = (32, 64, 128, 256, 512)
# (row, column) of each cell in the order the forward runs them
CELLS = ((0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (0, 1), (1, 1), (2, 1), (3, 1),
         (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (0, 4))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (2 * x.shape[-2], 2 * x.shape[-1]), align_corners=True)


class NestedUNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 deep_supervision: bool = False, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.deep_supervision = deep_supervision
        nb = WIDTHS
        for r, c in CELLS:
            # cell (r, c) takes the c cells left of it in its row and the
            # upsampled cell (r + 1, c - 1); column 0 takes the pooled row above
            cin = (in_channels if r == 0 else nb[r - 1]) if c == 0 else c * nb[r] + nb[r + 1]
            setattr(self, f"conv{r}_{c}", DoubleConvMid(cin, nb[r], nb[r], dtype, use_kernels))
        if deep_supervision:
            for i in range(1, 5):
                setattr(self, f"final{i}", nn.Conv2d(nb[0], num_classes, 1))
        else:
            self.final = nn.Conv2d(nb[0], num_classes, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits, ...}`` (module docstring)."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        rows = {}
        for r, c in CELLS:
            if c == 0:
                inp = x if r == 0 else max_pool2d(rows[r - 1][0], 2)
            else:
                inp = torch.cat([*rows[r], _up2(rows[r + 1][c - 1])], dim=1)
            rows.setdefault(r, []).append(getattr(self, f"conv{r}_{c}")(inp))
        top = rows[0]
        if self.deep_supervision:
            heads = [conv(top[i], getattr(self, f"final{i}"), self.dtype) for i in range(1, 5)]
            return {"main": heads[3], "side1": heads[0], "side2": heads[1], "side3": heads[2]}
        return {"main": conv(top[4], self.final, self.dtype)}
