"""Pooling primitives (NCHW).

Semantics match ``torch.nn.MaxPool2d`` with floor division of the spatial
dims, as the UNet encoder uses it. Ceil mode, average and adaptive pools
come with the models that need them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """k x k max pool, no padding, floor mode."""
    return F.max_pool2d(x, window, window if stride is None else stride)
