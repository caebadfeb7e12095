"""K1 and P2's int8 conv as ``torch.library`` custom ops (namespace ``unet_zoo``).

A kernel launched through ``ctypes`` on raw pointers cannot be traced by
``torch.export``; an op can. Each op here calls the kernel's wrapper, which
on a CUDA tensor launches the kernel (counted in ``LAUNCHES``) or raises,
and on a CPU tensor runs the plain version; a fake implementation gives the
output's shape, dtype and strides. So an exported program holds the op and
runs the kernel wherever it is loaded on the card. The models call the ops,
so eager serving takes the same path.

* ``torch.ops.unet_zoo.fused_up_concat_conv(y, skip, wt, bt, wc, scale,
  bias, wt_k, wc_k)``: K1 (``fused_up.fused_up_concat_conv``), channels-last
  [B, Co, 2Hc, 2Wc] in ``skip``'s dtype.
* ``torch.ops.unet_zoo.int8_conv(x, s_x, wp, scale, bias, stride,
  out_dtype, ksize, padding, dilation)``: P2's conv
  (``int8_gemm.int8_conv3x3``), NHWC [B, Ho, Wo, Co] in ``out_dtype``.

The wrappers are looked up when an op runs, so a check that wraps
``fused_up.fused_up_concat_conv`` or ``int8_gemm.int8_conv3x3`` sees every
launch an op makes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.library import custom_op

from unet_zoo_tpu_torch.ops.kernels import fused_up, int8_gemm

NAMESPACE = "unet_zoo"
CL = torch.channels_last


@custom_op(f"{NAMESPACE}::fused_up_concat_conv", mutates_args=())
def fused_up_concat_conv(y: torch.Tensor, skip: torch.Tensor, wt: torch.Tensor,
                         bt: torch.Tensor, wc: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, wt_k: torch.Tensor,
                         wc_k: torch.Tensor) -> torch.Tensor:
    out = fused_up.fused_up_concat_conv(y, skip, wt, bt, wc, scale, bias, (wt_k, wc_k))
    return out.contiguous(memory_format=CL)


@fused_up_concat_conv.register_fake
def _(y, skip, wt, bt, wc, scale, bias, wt_k, wc_k):
    b, _, hc, wcs = y.shape
    return torch.empty((b, wc.shape[1], 2 * hc, 2 * wcs), dtype=skip.dtype, device=y.device,
                       memory_format=CL)


@custom_op(f"{NAMESPACE}::int8_conv", mutates_args=())
def int8_conv(x: torch.Tensor, s_x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], stride: int, out_dtype: torch.dtype, ksize: int,
              padding: int, dilation: int) -> torch.Tensor:
    return int8_gemm.int8_conv3x3(x, s_x, wp, scale, bias, stride, out_dtype, ksize, padding,
                                  dilation).contiguous()


@int8_conv.register_fake
def _(x, s_x, wp, scale, bias, stride, out_dtype, ksize, padding, dilation):
    b, h, w, _ = x.shape
    ho, wo = (int8_gemm.conv_out_size(n, stride, ksize, padding, dilation) for n in (h, w))
    return torch.empty((b, ho, wo, wp.shape[0]), dtype=out_dtype, device=x.device)
