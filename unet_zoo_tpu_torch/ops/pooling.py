"""Pooling primitives (NCHW).

Semantics match ``torch.nn.MaxPool2d`` with floor division of the spatial
dims, as the UNet encoder and mmunet's morphology use it; padding is
filled with -inf, as ``unet_zoo_tpu/ops/pooling.py`` does. ``avg_pool2d``
matches ``AvgPool2d`` with ``count_include_pad`` (the MedT family's
stride-2 axial blocks). Ceil mode and the adaptive pools come with the
models that need them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    """k x k max pool, -inf padding, floor mode.

    A stride-1 window above 3 is separable: two 1-D passes take 2k compares
    per output instead of k^2 and give the same result, as in the JAX
    package (mmunet's 7x7 morphology)."""
    stride = window if stride is None else stride
    if stride == 1 and window > 3:
        x = F.max_pool2d(x, (window, 1), 1, (padding, 0))
        return F.max_pool2d(x, (1, window), 1, (0, padding))
    return F.max_pool2d(x, window, stride, padding)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    """k x k average pool, floor mode: the window sum in float32 over the
    window area (zero padding counted), returned in ``x.dtype``."""
    stride = window if stride is None else stride
    return F.avg_pool2d(x.float(), window, stride, padding,
                        count_include_pad=True).to(x.dtype)
