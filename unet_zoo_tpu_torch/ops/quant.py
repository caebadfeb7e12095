"""int8 post-training quantisation: the arithmetic of the JAX package's
``_QuantConv`` (``unet_zoo_tpu/nn/blocks.py:85-100``) and the plain int8 conv.

* Weights, symmetric per output channel:
  ``s_w = max(max |k| over (kh, kw, cin), 1e-12) / 127`` and
  ``wq = clip(round(k / s_w), -127, 127)``, in float32 on the *served* weight
  (already rounded to bfloat16 when the predictor casts its parameters).
* Activations, symmetric per tensor with a calibrated absmax:
  ``s_x = max(absmax, 1e-12) / 127`` and ``xq = clip(round(x / s_x), -127, 127)``.
* Dequantisation: ``acc * (s_x * s_w) + bias`` in float32, the product of the
  scales taken first as one float32 vector, then one rounding to the compute
  type.

Every division is a true float32 division by a tensor (ATen turns a division
by a Python number on the card into a multiply by its reciprocal, which can
land one ulp away), and ``torch.round`` rounds half to even, as ``jnp.round``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

QMAX = 127.0
EPS = 1e-12


def _over_qmax(t: torch.Tensor) -> torch.Tensor:
    """``max(t, EPS) / 127`` as a true float32 division."""
    t = torch.clamp(t.float(), min=EPS)
    return t / torch.full_like(t, QMAX)


def weight_scale(kernel: torch.Tensor) -> torch.Tensor:
    """Per-output-channel scale ``s_w`` [Co] of an OIHW ``kernel``, float32."""
    return _over_qmax(kernel.float().abs().amax(dim=(1, 2, 3)))


def quantize_weight(kernel: torch.Tensor, s_w: torch.Tensor) -> torch.Tensor:
    """``clip(round(k / s_w), -127, 127)`` as int8, OIHW."""
    q = torch.round(kernel.float() / s_w.view(-1, 1, 1, 1))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def activation_scale(absmax: torch.Tensor) -> torch.Tensor:
    """Per-tensor scale ``s_x`` (0-dim float32) from a calibrated absmax."""
    return _over_qmax(absmax.reshape(()))


def quantize_activation(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s_x), -127, 127)`` as int8 in ``x``'s layout; ``x``
    is divided in float32."""
    q = torch.round(x.float() / s_x.to(x.device))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def int8_conv2d_exact(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                      padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """The plain int8 conv: NCHW int8 ``xq`` with OIHW int8 ``wq`` (any
    kernel size, ``dilation`` as ``lax.conv``'s ``rhs_dilation``), the exact
    int32 sums. Computed as a float64 convolution, which holds every partial
    sum exactly (|sum| <= 127 * 127 * K, below 2^53); float32 would not
    (127 * 127 * 9216 is above 2^24)."""
    acc = F.conv2d(xq.double(), wq.double(), stride=stride, padding=padding,
                   dilation=dilation)
    return acc.to(torch.int32)


def dequantize(acc: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               dtype: torch.dtype, channel_dim: int = 1) -> torch.Tensor:
    """``acc * scale + bias`` in float32 (each product and sum rounded once,
    no fused multiply-add), rounded once to ``dtype``; ``scale`` and ``bias``
    [Co] lie along ``channel_dim``."""
    shape = [1] * acc.dim()
    shape[channel_dim] = -1
    y = acc.float() * scale.float().view(shape)
    if bias is not None:
        y = y + bias.float().view(shape)
    return y.to(dtype)
