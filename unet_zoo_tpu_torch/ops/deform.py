"""Modulated deformable convolution (DCNv2, one offset group), channels-last.

Counterpart of ``unet_zoo_tpu/ops/deform.py::deform_conv2d``, which the JAX
package runs through XLA: the module path of ``wranet``'s
``DeformableConv``. Plain PyTorch, batched over images (no torchvision):

* every sample position is clamped to a 1-pixel zero frame around the
  image ([-1, H] and [-1, W]; a tie at a bound splits the gradient as
  ``jnp.clip`` does), shifted by +1 into the padded image, and its
  top-left corner clamped to [0, Hp - 2] x [0, Wp - 2], so samples outside
  the image interpolate to zero (torchvision's semantics);
* the four corner weights fold the modulation mask;
* in bfloat16 the corner weights and each tap's blended column are in x's
  type, and the tap contraction accumulates in float32, as the JAX path does.

``sample_positions`` is shared with K8's plain version
(``ops/kernels/deform.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class Samples(NamedTuple):
    """Each (image, output pixel, tap)'s top-left corner in the flattened
    padded image (``idx``, [B, N, K] int64) and its four corner weights
    times the mask (``cw``, [B, N, K, 4] float32, corners in the order
    (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1))."""

    idx: torch.Tensor
    cw: torch.Tensor


def out_size(h: int, w: int, kh: int, kw: int, stride: int, padding: int, dilation: int):
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    return ho, wo


def clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``v`` clamped to [lo, hi] with ``jnp.clip``'s gradient: a value that
    sits exactly on a bound passes half the gradient, where ``torch.clamp``
    passes all of it. wranet's offset convs are zero at init, so every
    border tap samples exactly on a bound on the first train step. The
    bounds are filled on v's device, so a CUDA graph can capture it."""
    return torch.minimum(torch.maximum(v, v.new_full((), lo)), v.new_full((), hi))


def sample_positions(h: int, w: int, offset: torch.Tensor, mask: torch.Tensor, kh: int, kw: int,
                     stride: int = 1, padding: int = 1, dilation: int = 1) -> Samples:
    """Clamped bilinear sample positions and weights, in float32.

    offset: [B, Ho, Wo, 2K] with (dy, dx) pairs per tap in row-major kernel
    order; mask: [B, Ho, Wo, K]. The padded image is (H + 2) x (W + 2)."""
    b, ho, wo, _ = offset.shape
    k = kh * kw
    dev = offset.device
    wp = w + 2
    off = offset.float().reshape(b, ho, wo, k, 2)
    taps = torch.arange(k, device=dev)
    ky = ((taps // kw) * dilation).float()
    kx = ((taps % kw) * dilation).float()
    by = (torch.arange(ho, device=dev) * stride - padding).float()
    bx = (torch.arange(wo, device=dev) * stride - padding).float()
    py = clip((by[:, None, None] + ky) + off[..., 0], -1.0, float(h)) + 1.0
    px = clip((bx[None, :, None] + kx) + off[..., 1], -1.0, float(w)) + 1.0
    y0 = torch.clamp(torch.floor(py), 0, h)          # [0, Hp - 2]
    x0 = torch.clamp(torch.floor(px), 0, w)          # [0, Wp - 2]
    wy1, wx1 = py - y0, px - x0
    m = mask.float()
    cw = torch.stack([(1 - wy1) * (1 - wx1) * m, (1 - wy1) * wx1 * m,
                      wy1 * (1 - wx1) * m, wy1 * wx1 * m], dim=-1)
    idx = (y0.long() * wp + x0.long()).reshape(b, ho * wo, k)
    return Samples(idx, cw.reshape(b, ho * wo, k, 4))


def padded_rows(x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] with a 1-pixel zero frame, as [B, (H + 2)(W + 2), C] rows."""
    b, h, w, c = x.shape
    return F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(b, (h + 2) * (w + 2), c)


def gather_corners(rows: torch.Tensor, idx: torch.Tensor, wp: int) -> torch.Tensor:
    """The four bilinear corners of one tap's samples: ``rows`` (from
    :func:`padded_rows`, padded width ``wp``) read at ``idx`` [B, N];
    returns [B, N, 4, C] in the rows' type."""
    b, n = idx.shape
    at = torch.stack([idx, idx + 1, idx + wp, idx + wp + 1], dim=-1).reshape(b, n * 4, 1)
    return torch.gather(rows, 1, at.expand(-1, -1, rows.shape[-1])).reshape(b, n, 4, -1)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Modulated deformable conv, the JAX XLA path's arithmetic.

    x: [B, H, W, C]; offset: [B, Ho, Wo, 2K] ((dy, dx) pairs per tap);
    mask: [B, Ho, Wo, K]; weight: [kh, kw, C, O]; bias [O] or None.
    Returns [B, Ho, Wo, O] in x's type. One tap at a time, so the gathered
    corners of one tap are the largest temporary."""
    b, h, w, c = x.shape
    kh, kw, _, o = weight.shape
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    s = sample_positions(h, w, offset, mask, kh, kw, stride, padding, dilation)
    cdt = x.dtype
    rows = padded_rows(x)
    cw = s.cw.to(cdt).float()                                       # rounded as in JAX
    wk = weight.to(cdt).float().reshape(kh * kw, c, o)
    out = torch.zeros(b, ho * wo, o, dtype=torch.float32, device=x.device)
    for ki in range(kh * kw):
        corners = gather_corners(rows, s.idx[..., ki], w + 2).float()   # [B, N, 4, C]
        col = (corners * cw[:, :, ki, :, None]).sum(dim=2).to(cdt)
        out = out + col.float() @ wk[ki]
    if bias is not None:
        out = out + bias.float()
    return out.reshape(b, ho, wo, o).to(cdt)
