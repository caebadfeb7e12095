"""Image resizing (NCHW).

Counterpart of ``unet_zoo_tpu/ops/resize.py::resize_bilinear``, which
writes the resize as two interpolation matmuls for the TPU's matrix unit.
The JAX package left it to XLA, so here it is ATen's ``F.interpolate``,
with both PyTorch sampling conventions (``align_corners`` True and False).
ATen interpolates a bfloat16 input in float32 and rounds once, as the JAX
function does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to spatial ``size`` = (H_out, W_out)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)
