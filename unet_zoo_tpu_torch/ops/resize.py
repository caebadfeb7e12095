"""Image resizing (NCHW).

Counterpart of ``unet_zoo_tpu/ops/resize.py``. ``resize_bilinear``: the JAX
package writes the resize as two interpolation matmuls for the TPU's matrix
unit and left it to XLA, so here it is ATen's ``F.interpolate``, with both
PyTorch sampling conventions (``align_corners`` True and False). ATen
interpolates a bfloat16 input in float32 and rounds once, as the JAX function
does. ``resize_nearest`` and ``upsample2x_nearest`` copy pixels, so they are
exact in every type.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to spatial ``size`` = (H_out, W_out)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=align_corners)


@functools.lru_cache(maxsize=None)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """PyTorch's legacy 'nearest' index rule, floor(i * in / out), computed in
    float64 and clipped to the input, as ``unet_zoo_tpu/ops/resize.py:42-46``."""
    idx = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-resize NCHW ``x`` to spatial ``size`` (the legacy 'nearest'
    rule of :func:`_nearest_indices`)."""
    h_out, w_out = size
    h_in, w_in = x.shape[-2:]
    if (h_in, w_in) == (h_out, w_out):
        return x
    hi = torch.from_numpy(_nearest_indices(h_in, h_out)).to(x.device)
    wi = torch.from_numpy(_nearest_indices(w_in, w_out)).to(x.device)
    return x.index_select(-2, hi).index_select(-1, wi)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample (``nn.Upsample(scale_factor=2)``'s default): every
    pixel copied into a 2x2 block; keeps ``x``'s memory format."""
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]), mode="nearest")
