"""U-Transformer: a UNet encoder with multi-head self-attention at the
bottleneck and a decoder of cross-attention blocks, each attending at one
pooled common resolution (``attn_res``, the registry's
``common_attn_res_for_QK_V``, 64 x 64 by default). Counterpart of
``unet_zoo_tpu/models/unet_transformer.py``; module names follow the
original zoo (``inc.conv_op``, ``down{1-3}.maxpool_conv.1.double_conv``,
``MHSA.{query,key,value}``, ``up{1-3}.MHCA.*``, ``up{1-3}.conv``,
``outc.conv``).

As in the original zoo: both attentions normalise over the *query* axis
(``Softmax(dim=1)``), the projections are single d x d matrices without
bias applied as ``x @ W``, and the cross attention takes its queries and
keys from the upsampled path Y and its values from the skip S, each
adaptive-average-pooled to ``attn_res`` (which may enlarge as well as
shrink). Both products are plain matmuls. The 14 3x3 convs of ``inc``,
``down*`` and each block's ``conv`` are int8-gated.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import (Down, DoubleConv, OutConv, batch_norm, conv,
                                   double_conv_norm_act)
from unet_zoo_tpu_torch.nn.blocks import _bn, _double_conv
from unet_zoo_tpu_torch.nn.posenc import sincos_posenc_2d
from unet_zoo_tpu_torch.ops import adaptive_avg_pool2d, max_pool2d, resize_bilinear


class MultiHeadDense(nn.Module):
    """The original zoo's ``MultiHeadDense``: ``x @ weight``, a d x d matrix
    (in, out) without bias; drawn at std sqrt(0.25 / d), as the port draws
    ``nn.Linear``."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, d))

    def draw_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, (0.25 / self.weight.shape[0]) ** 0.5, generator=generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return x @ self.weight.to(dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the queries of q k^T / sqrt(d), times v ([B, n, d] each);
    the scale is rounded to the operands' type, as JAX divides by it. The
    logits are formed transposed, [B, key, query], so that the softmax runs
    over the contiguous last axis (ATen's softmax over a strided axis took
    15.9 of 25.8 ms of a B=8/256px forward on the H100), and the product
    reads them transposed back."""
    scale = float(torch.tensor(math.sqrt(q.shape[-1])).to(q.dtype))
    attn_t = torch.softmax(k @ q.transpose(1, 2) / scale, dim=-1)
    return attn_t.transpose(1, 2) @ v


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, hw, C]."""
    return x.flatten(2).transpose(1, 2)


def _map(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, hw, C] -> NCHW (channels_last memory)."""
    return t.transpose(1, 2).unflatten(2, (h, w)).contiguous(memory_format=torch.channels_last)


class BottleneckSelfAttention(nn.Module):
    """Self-attention over the bottleneck's positions with the sinusoidal
    2D position encoding added to its input (the original zoo's
    ``MultiHeadSelfAttention``)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.query = MultiHeadDense(channels)
        self.key = MultiHeadDense(channels)
        self.value = MultiHeadDense(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, h, w = x.shape
        flat = _tokens(x + sincos_posenc_2d(x))
        dt = self.dtype
        out = _attend(self.query(flat, dt), self.key(flat, dt), self.value(flat, dt))
        return _map(out, h, w)


class MultiHeadCrossAttention(nn.Module):
    """The original zoo's ``MultiHeadCrossAttention`` of a ``TransformerUp``:
    Y (``y_channels``, the deeper map) and S (``s_channels``, the skip at
    twice its size), each with its position encoding; S max-pooled and both
    taken to S's channels by 1x1 conv, BN, ReLU; attention at ``attn_res``
    (queries and keys from Y, values from S), resized bilinearly to twice
    Y's size, then 1x1 conv, BN, ReLU; concatenated with Y resized likewise
    through a 3x3 conv, a 1x1 conv, BN, ReLU."""

    def __init__(self, s_channels: int, y_channels: int, attn_res: Tuple[int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn_res = tuple(attn_res)
        cc = s_channels
        self.Sconv_process = nn.Sequential(nn.MaxPool2d(2), nn.Conv2d(s_channels, cc, 1),
                                           _bn(cc), nn.ReLU(inplace=True))
        self.Yconv_process = nn.Sequential(nn.Conv2d(y_channels, cc, 1), _bn(cc),
                                           nn.ReLU(inplace=True))
        self.query = MultiHeadDense(cc)
        self.key = MultiHeadDense(cc)
        self.value = MultiHeadDense(cc)
        self.conv_after_attention = nn.Sequential(nn.Conv2d(cc, cc, 1), _bn(cc),
                                                  nn.ReLU(inplace=True))
        self.Yconv2_process = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(y_channels, y_channels, 3, padding=1), nn.Conv2d(y_channels, cc, 1),
            _bn(cc), nn.ReLU(inplace=True))

    def forward(self, y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        _, _, yh, yw = y.shape
        s_pe = s + sincos_posenc_2d(s)
        y_pe = y + sincos_posenc_2d(y)
        sp = conv(max_pool2d(s_pe, 2), self.Sconv_process[1], dt)
        sp = torch.relu(batch_norm(sp, self.Sconv_process[2]))
        yp = torch.relu(batch_norm(conv(y_pe, self.Yconv_process[0], dt), self.Yconv_process[1]))
        ha, wa = self.attn_res
        qk_src = _tokens(adaptive_avg_pool2d(yp, (ha, wa)))
        v_src = _tokens(adaptive_avg_pool2d(sp, (ha, wa)))
        z = _attend(self.query(qk_src, dt), self.key(qk_src, dt), self.value(v_src, dt))
        z = resize_bilinear(_map(z, ha, wa), (2 * yh, 2 * yw), align_corners=True)
        caa = self.conv_after_attention
        z = torch.relu(batch_norm(conv(z, caa[0], dt), caa[1]))
        yc = self.Yconv2_process
        y2 = resize_bilinear(y_pe, (2 * yh, 2 * yw), align_corners=True)
        y2 = conv(conv(y2, yc[1], dt), yc[2], dt)
        y2 = torch.relu(batch_norm(y2, yc[3]))
        return torch.cat([z, y2], dim=1)


class TransformerUp(nn.Module):
    """:class:`MultiHeadCrossAttention` (``MHCA``), then the double conv
    (``conv.{0,1,3,4}``, both convs int8-gated) to S's channels."""

    def __init__(self, s_channels: int, y_channels: int, attn_res: Tuple[int, int],
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.MHCA = MultiHeadCrossAttention(s_channels, y_channels, attn_res, dtype)
        self.conv = _double_conv(2 * s_channels, s_channels)

    def forward(self, y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return double_conv_norm_act(self.MHCA(y, s), self.conv, self.dtype, self.use_kernels)


class UTransformer(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1, bilinear: bool = True,
                 attn_res: Tuple[int, int] = (64, 64), dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        del bilinear   # accepted, as in JAX, where it changes nothing
        self.dtype = dtype
        args = (dtype, use_kernels)
        self.inc = DoubleConv(in_channels, 64, *args)
        self.down1 = Down(64, 128, *args)
        self.down2 = Down(128, 256, *args)
        self.down3 = Down(256, 512, *args)
        self.MHSA = BottleneckSelfAttention(512, dtype)
        self.up1 = TransformerUp(256, 512, attn_res, *args)
        self.up2 = TransformerUp(128, 256, attn_res, *args)
        self.up3 = TransformerUp(64, 128, attn_res, *args)
        self.outc = OutConv(64, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.MHSA(self.down3(x3))
        u = self.up1(x4, x3)
        u = self.up2(u, x2)
        u = self.up3(u, x1)
        return {"main": self.outc(u)}
