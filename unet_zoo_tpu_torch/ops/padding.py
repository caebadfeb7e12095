"""Spatial padding helpers (NCHW)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_to_match(x: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Symmetrically zero-pad NCHW ``x`` up to ``target_hw``.

    The decoder pad-to-skip-size of the original zoo: pad ``diff // 2`` low
    and ``diff - diff // 2`` high on each spatial dim. A negative diff
    center-crops, which is what ``F.pad`` does with negative padding.
    """
    dh = target_hw[0] - x.shape[-2]
    dw = target_hw[1] - x.shape[-1]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
