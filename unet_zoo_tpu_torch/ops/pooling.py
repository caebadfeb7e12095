"""Pooling primitives (NCHW).

Counterpart of ``unet_zoo_tpu/ops/pooling.py``. ``max_pool2d`` matches
``torch.nn.MaxPool2d``: floor division of the spatial dims as the UNet
encoder and mmunet's morphology use it, or with ``ceil_mode`` as U²-Net uses
it; padding is filled with -inf, as the JAX module does. ``avg_pool2d``
matches ``AvgPool2d`` with ``count_include_pad`` (the MedT family's stride-2
axial blocks). ``global_avg_pool`` and ``adaptive_avg_pool2d`` average in
float32 and return the input's type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _ceil_pad(size: int, window: int, stride: int) -> int:
    """Extra high-side padding so that out = ceil((size - window) / stride) + 1
    (JAX ``_ceil_pad``, ``unet_zoo_tpu/ops/pooling.py:15``)."""
    out = -(-(size - window) // stride) + 1
    return max(0, (out - 1) * stride + window - size)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None,
               padding: int = 0, ceil_mode: bool = False) -> torch.Tensor:
    """k x k max pool, -inf padding, floor mode or ``ceil_mode``.

    Ceil mode pads the high side of each spatial dim with -inf by
    :func:`_ceil_pad`, as JAX does, rather than by ATen's rule (which also
    drops a last window that would start in the padding).

    A stride-1 window above 3 is separable: two 1-D passes take 2k compares
    per output instead of k^2 and give the same result, as in the JAX
    package (mmunet's 7x7 morphology)."""
    stride = window if stride is None else stride
    if ceil_mode:
        eh = _ceil_pad(x.shape[-2] + 2 * padding, window, stride)
        ew = _ceil_pad(x.shape[-1] + 2 * padding, window, stride)
        if padding or eh or ew:
            x = F.pad(x, (padding, padding + ew, padding, padding + eh), value=float("-inf"))
        return F.max_pool2d(x, window, stride)
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


def global_avg_pool(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """The mean over H and W, taken in float32, in ``x.dtype``."""
    return x.float().mean(dim=(-2, -1), keepdim=keepdims).to(x.dtype)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` (bin i averages input [floor(i in / out),
    ceil((i + 1) in / out))), down- or up-sizing, computed in float32 and
    returned in ``x.dtype``; ``x`` itself when the size is already right."""
    if tuple(x.shape[-2:]) == tuple(output_size):
        return x
    return F.adaptive_avg_pool2d(x.float(), tuple(output_size)).to(x.dtype)
