"""TransAttUNet: a bilinear UNet whose bottleneck adds a learned 2D
position embedding and then sums a spatial self-attention (PAM) and a
channel attention (the original zoo's scaled dot-product attention, a C x C
attention over the positions). Counterpart of
``unet_zoo_tpu/models/transatt_unet.py``; module names follow the original
zoo (``inc.double_conv``, ``down{1-4}.maxpool_conv.1.double_conv``,
``pos.{row,col}_embed``, ``pam.{query,key,value}_conv``, ``pam.gamma``,
``up{1-4}.conv.double_conv``, ``outc.conv``).

Its 18 3x3 convs (``inc``, ``down*``, ``up*``) are int8-gated. PAM's
``gamma`` starts at zero, so a freshly drawn model adds nothing of the
spatial attention. The channel attention's dropout (0.1) on its attention
matrix draws from the forward's ``generator`` in training.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import Down, ZooDoubleConv, OutConv, UpBilinear, conv
from unet_zoo_tpu_torch.nn.transformer import dropout

# the bottleneck's position tables: rows and columns of at most POS_LEN
# positions (images of at most 16 * POS_LEN pixels a side), POS_FEATS each
POS_LEN, POS_FEATS = 32, 256


class PAM(nn.Module):
    """Position attention: softmax(q^T k) over the hw positions (q, k 1x1
    convs to C / 8, v to C), times the learned scale ``gamma`` (zero at
    init), plus the input."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.query_conv = nn.Conv2d(channels, channels // 8, 1)
        self.key_conv = nn.Conv2d(channels, channels // 8, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dt = self.dtype
        q = conv(x, self.query_conv, dt).flatten(2)           # [B, C/8, hw]
        k = conv(x, self.key_conv, dt).flatten(2)
        v = conv(x, self.value_conv, dt).flatten(2)           # [B, C, hw]
        attn = torch.softmax(q.transpose(1, 2) @ k, dim=-1)   # [B, hw (query), hw (key)]
        out = (v @ attn.transpose(1, 2)).view(b, c, h, w)
        return self.gamma.to(x.dtype) * out + x


class ChannelSDPA(nn.Module):
    """The original zoo's ScaledDotProductAttention as written: a C x C
    attention softmax((x / temperature**0.5) x^T) over the hw positions,
    dropout on it in training, applied to x."""

    def __init__(self, temperature: float, attn_dropout: float = 0.1):
        super().__init__()
        self.temperature = temperature
        self.attn_dropout = attn_dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = x.flatten(2)                                   # [B, C, hw]
        scale = self.temperature ** 0.5
        attn = torch.softmax((flat / scale) @ flat.transpose(1, 2), dim=-1)   # [B, C, C]
        attn = dropout(attn, self.attn_dropout, self.training, generator)
        return (attn @ flat).view(b, c, h, w)


class LearnedPosEmbedding2D(nn.Module):
    """Column and row embedding tables, concatenated over the channels
    (columns first), broadcast over an h x w map; h and w at most
    ``len_embedding``. Drawn from U[0, 1) as in JAX."""

    def __init__(self, num_pos_feats: int = POS_FEATS, len_embedding: int = POS_LEN):
        super().__init__()
        self.row_embed = nn.Embedding(len_embedding, num_pos_feats)
        self.col_embed = nn.Embedding(len_embedding, num_pos_feats)

    def draw_parameters(self, generator: torch.Generator) -> None:
        for t in (self.row_embed.weight, self.col_embed.weight):
            t.uniform_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[1, 2 * feats, h, w] in ``x.dtype`` for NCHW ``x``."""
        h, w = x.shape[-2:]
        n = self.row_embed.num_embeddings
        if h > n or w > n:
            raise ValueError(f"TransAttUNet's position tables hold {n} rows and columns; the "
                             f"bottleneck is {h} x {w} (images of at most {16 * n} pixels a "
                             "side)")
        f = self.row_embed.embedding_dim
        cols = self.col_embed.weight[:w].t()[:, None, :].expand(f, h, w)
        rows = self.row_embed.weight[:h].t()[:, :, None].expand(f, h, w)
        return torch.cat([cols, rows], dim=0)[None].to(x.dtype)


class TransAttUNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1, bilinear: bool = True,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        factor = 2 if bilinear else 1
        args = (dtype, use_kernels)
        self.inc = ZooDoubleConv(in_channels, 64, 64, *args)
        self.down1 = Down(64, 128, *args)
        self.down2 = Down(128, 256, *args)
        self.down3 = Down(256, 512, *args)
        self.down4 = Down(512, 1024 // factor, *args)
        self.pos = LearnedPosEmbedding2D()
        self.pam = PAM(1024 // factor, dtype)
        self.sdpa = ChannelSDPA(512)
        # the original zoo's Up(in, out) with mid = in // 2
        self.up1 = UpBilinear(512 + 1024 // factor, 512 // factor, 1024 // 2, *args)
        self.up2 = UpBilinear(256 + 512 // factor, 256 // factor, (512 // factor + 256) // 2,
                              *args)
        self.up3 = UpBilinear(128 + 256 // factor, 128 // factor, (256 // factor + 128) // 2,
                              *args)
        self.up4 = UpBilinear(64 + 128 // factor, 64, (128 // factor + 64) // 2, *args)
        self.outc = OutConv(64, num_classes, dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``.
        ``generator`` feeds the channel attention's dropout in training."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x5 = x5 + self.pos(x5)
        # both attentions leave NCHW-contiguous maps: back to channels_last,
        # which the decoder's int8 convs read in place
        x5 = (self.sdpa(x5, generator) + self.pam(x5)).contiguous(
            memory_format=torch.channels_last)
        u = self.up1(x5, x4)
        u = self.up2(u, x3)
        u = self.up3(u, x2)
        u = self.up4(u, x1)
        return {"main": self.outc(u)}
