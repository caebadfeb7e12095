"""UCTransNet: a UNet (base 16 channels) whose four skips pass through a
channel transformer (CTrans): per-scale patch embeddings with learned
position tables, layers of channel-wise cross attention over the
concatenated skip channels (KV_size = their sum), a reconstruction back to
each skip's map, and CCA-gated decoder fusion. Counterpart of
``unet_zoo_tpu/models/uctransnet.py``; module names follow the original
zoo (``inc.{conv,norm}``, ``down{d}.nConvs.{i}``,
``mtc.embeddings_{e}.{patch_embeddings,position_embeddings}``,
``mtc.encoder.layer.{l}.channel_attn.{query{i},key,value}.{head}`` (one
``Linear`` a head, computed as one stacked product), ``...out{i}``,
``...attn_norm{i}``, ``...ffn{i}.{fc1,fc2}``, ``mtc.encoder.encoder_norm{i}``,
``mtc.reconstruct_{e}.{conv,norm}``, ``up{u}.coatt.mlp_{x,g}.1``,
``up{u}.nConvs.{i}``, ``outc``).

The position tables hold (image_size / 32)^2 tokens, so the model is built
for one image size. No conv is int8-gated (JAX's are plain convs). Dropout
(0.1 on the embeddings and in each FFN) draws from the forward's
``generator`` in training. ``vis=True`` adds ``attn_weights``: per layer, a
tuple of each scale's head-mean attention probabilities [B, C_i, KV].
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import batch_norm, conv
from unet_zoo_tpu_torch.nn.transformer import dropout, layer_norm, linear
from unet_zoo_tpu_torch.ops import global_avg_pool, max_pool2d, upsample2x_nearest

# the embeddings' and the FFNs' dropout (the original zoo's config, which JAX
# also keeps as its modules' defaults)
DROPOUT_RATE = 0.1
PIPELINE_REFUSAL = ("uctransnet's pipelined channel-transformer bridge (bridge_pipeline) is not "
                    "ported yet (ROADMAP Queue 1 item 10b); build it without bridge_pipeline")


def get_uctransnet_config() -> Dict[str, Any]:
    """The default config, as a plain dict (JAX's ``get_uctransnet_config``)."""
    base = 16
    channel_nums = [base * (2 ** i) for i in range(4)]
    return {
        "base_channel": base,
        "transformer": {
            "embeddings_dropout_rate": 0.1,
            "attention_dropout_rate": 0.0,
            "dropout_rate": 0.1,
            "num_heads": 4,
            "num_layers": 4,
        },
        "KV_size": sum(channel_nums),
        "patch_sizes": (32, 16, 8, 4),
        "expand_ratio": 4,
        "vis": False,
    }


class ConvBatchNorm(nn.Module):
    """conv3x3 -> BatchNorm -> ReLU (the original zoo's ``ConvBatchNorm``)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm = nn.BatchNorm2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(batch_norm(conv(x, self.conv, self.dtype), self.norm))


class _NConvs(nn.Module):
    """Two :class:`ConvBatchNorm` (``nConvs.{0,1}``)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.nConvs = nn.Sequential(ConvBatchNorm(in_channels, out_channels, dtype),
                                    ConvBatchNorm(out_channels, out_channels, dtype))


class ChannelEmbedding(nn.Module):
    """A p x p stride-p conv (C to C) as tokens [B, N, C], plus a learned
    position table of N = (size / p)^2 tokens (zero at init), then dropout."""

    def __init__(self, patch_size: int, size: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_embeddings = nn.Conv2d(channels, channels, patch_size, stride=patch_size)
        self.position_embeddings = nn.Parameter(torch.zeros(1, (size // patch_size) ** 2,
                                                            channels))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        tokens = conv(x, self.patch_embeddings, self.dtype).flatten(2).transpose(1, 2)
        if tokens.shape[1] != self.position_embeddings.shape[1]:
            raise ValueError(f"uctransnet was built for {self.position_embeddings.shape[1]} "
                             f"tokens a scale; this input gives {tokens.shape[1]} (build it "
                             "with the image_size it serves)")
        tokens = tokens + self.position_embeddings.to(tokens.dtype)
        return dropout(tokens, DROPOUT_RATE, self.training, generator)


def _heads(channels: int, num_heads: int) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(channels, channels, bias=False) for _ in range(num_heads))


def _multihead(x: torch.Tensor, heads: nn.ModuleList, dtype: torch.dtype) -> torch.Tensor:
    """Every head's projection of tokens [B, N, C] as one product: [B, h, N, C']."""
    w = torch.stack([m.weight for m in heads]).to(dtype)     # [h, C', C]
    return torch.einsum("bnc,hdc->bhnd", x, w)


class ChannelCrossAttention(nn.Module):
    """The original zoo's ``Attention_org``: each scale's queries attend
    over the concatenated KV channels. Scores q^T k over the tokens, over
    sqrt(KV_size); an affine-free instance norm over each head's (C_i, KV)
    map (eps 1e-5, in float32); softmax over KV; P V^T; the mean over heads;
    ``out{i}`` (no bias). Attention dropout is 0 in the zoo's config."""

    def __init__(self, channel_num: Sequence[int], num_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kv_size = sum(channel_num)
        for i, c in enumerate(channel_num):
            setattr(self, f"query{i + 1}", _heads(c, num_heads))
            setattr(self, f"out{i + 1}", nn.Linear(c, c, bias=False))
        self.key = _heads(self.kv_size, num_heads)
        self.value = _heads(self.kv_size, num_heads)

    def forward(self, embs: List[torch.Tensor], emb_all: torch.Tensor, vis: bool = False):
        dt = self.dtype
        k = _multihead(emb_all, self.key, dt)                     # [B, h, N, KV]
        v = _multihead(emb_all, self.value, dt)
        scale = float(self.kv_size) ** 0.5
        outs, weights = [], []
        for i, emb in enumerate(embs):
            q = _multihead(emb, getattr(self, f"query{i + 1}"), dt)    # [B, h, N, Ci]
            scores = q.transpose(2, 3) @ k / scale                     # [B, h, Ci, KV]
            scores = F.instance_norm(scores.to(torch.promote_types(q.dtype, torch.float32)),
                                     eps=1e-5).to(q.dtype)
            probs = torch.softmax(scores, dim=-1)
            if vis:
                weights.append(probs.mean(dim=1))
            ctx = (probs @ v.transpose(2, 3)).mean(dim=1).transpose(1, 2)   # [B, N, Ci]
            outs.append(linear(ctx, getattr(self, f"out{i + 1}"), dt))
        return outs, (tuple(weights) if vis else None)


class _Mlp(nn.Module):
    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, hidden)
        self.fc2 = nn.Linear(hidden, channels)


class CTransBlock(nn.Module):
    """The original zoo's ``Block_ViT``: pre-LN (eps 1e-6) channel cross
    attention with a residual, then a per-scale FFN (x4, exact GELU,
    dropout, back, dropout) with a residual."""

    def __init__(self, channel_num: Sequence[int], num_heads: int = 4, expand_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i, c in enumerate(channel_num):
            setattr(self, f"attn_norm{i + 1}", nn.LayerNorm(c, eps=1e-6))
            setattr(self, f"ffn_norm{i + 1}", nn.LayerNorm(c, eps=1e-6))
            setattr(self, f"ffn{i + 1}", _Mlp(c, c * expand_ratio))
        self.attn_norm = nn.LayerNorm(sum(channel_num), eps=1e-6)
        self.channel_attn = ChannelCrossAttention(channel_num, num_heads, dtype)

    def forward(self, embs: List[torch.Tensor], vis: bool = False,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype
        emb_all = layer_norm(torch.cat(embs, dim=2), self.attn_norm)
        cx = [layer_norm(e, getattr(self, f"attn_norm{i + 1}")) for i, e in enumerate(embs)]
        attended, weights = self.channel_attn(cx, emb_all, vis)
        outs = []
        for i, (e, a) in enumerate(zip(embs, attended)):
            e = e + a
            ffn = getattr(self, f"ffn{i + 1}")
            h = layer_norm(e, getattr(self, f"ffn_norm{i + 1}"))
            h = F.gelu(linear(h, ffn.fc1, dt))
            h = dropout(h, DROPOUT_RATE, self.training, generator)
            h = dropout(linear(h, ffn.fc2, dt), DROPOUT_RATE, self.training, generator)
            outs.append(e + h)
        return outs, weights


class _Encoder(nn.Module):
    def __init__(self, channel_num: Sequence[int], num_layers: int, num_heads: int,
                 expand_ratio: int, dtype: torch.dtype):
        super().__init__()
        self.layer = nn.ModuleList(CTransBlock(channel_num, num_heads, expand_ratio, dtype=dtype)
                                   for _ in range(num_layers))
        for i, c in enumerate(channel_num):
            setattr(self, f"encoder_norm{i + 1}", nn.LayerNorm(c, eps=1e-6))


class _Reconstruct(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 1)
        self.norm = nn.BatchNorm2d(channels)


class ChannelTransformer(nn.Module):
    """Embeddings -> ``num_layers`` CTrans blocks in sequence -> each
    scale's ``encoder_norm`` -> reconstruction (tokens as a map, nearest
    upsample by the patch size, 1x1 conv, BN, ReLU) plus the skip."""

    def __init__(self, channel_num: Sequence[int], size: int,
                 patch_sizes: Sequence[int] = (32, 16, 8, 4), num_layers: int = 4,
                 num_heads: int = 4, expand_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch_sizes = tuple(patch_sizes)
        for i, (c, p) in enumerate(zip(channel_num, patch_sizes)):
            setattr(self, f"embeddings_{i + 1}",
                    ChannelEmbedding(p, size >> i, c, dtype=dtype))
            setattr(self, f"reconstruct_{i + 1}", _Reconstruct(c))
        self.encoder = _Encoder(channel_num, num_layers, num_heads, expand_ratio, dtype)

    def forward(self, feats: List[torch.Tensor], vis: bool = False,
                generator: Optional[torch.Generator] = None):
        embs = [getattr(self, f"embeddings_{i + 1}")(f, generator) for i, f in enumerate(feats)]
        attn_weights = []
        for layer in self.encoder.layer:
            embs, w = layer(embs, vis, generator)
            attn_weights.append(w)
        outs = []
        for i, (e, f) in enumerate(zip(embs, feats)):
            e = layer_norm(e, getattr(self.encoder, f"encoder_norm{i + 1}"))
            b, n, c = e.shape
            hh = int(round(n ** 0.5))
            sp = e.transpose(1, 2).reshape(b, c, hh, hh).contiguous(
                memory_format=torch.channels_last)
            sp = F.interpolate(sp, scale_factor=self.patch_sizes[i], mode="nearest")
            rec = getattr(self, f"reconstruct_{i + 1}")
            sp = batch_norm(conv(sp, rec.conv, self.dtype), rec.norm)
            outs.append(torch.relu(sp) + f)
        return outs, (tuple(attn_weights) if vis else None)


class CCA(nn.Module):
    """The cross channel attention gate on the skip x: sigmoid of the mean
    of ``mlp_x(gap(x))`` and ``mlp_g(gap(g))`` (global average pools in
    float32) scales x's channels, then ReLU."""

    def __init__(self, f_g: int, f_x: int):
        super().__init__()
        self.mlp_x = nn.Sequential(nn.Flatten(), nn.Linear(f_x, f_x))
        self.mlp_g = nn.Sequential(nn.Flatten(), nn.Linear(f_g, f_x))

    def forward(self, g: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        att_x = linear(global_avg_pool(x, keepdims=False), self.mlp_x[1], dtype)
        att_g = linear(global_avg_pool(g, keepdims=False), self.mlp_g[1], dtype)
        scale = torch.sigmoid((att_x + att_g) / 2.0)[:, :, None, None]
        return torch.relu(x * scale)


class _UpBlockAttention(nn.Module):
    """Nearest x2 upsample, the CCA-gated skip, concat[gated, up], two
    :class:`ConvBatchNorm` (the original zoo's ``UpBlock_attention``)."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.coatt = CCA(in_channels, skip_channels)
        self.nConvs = nn.Sequential(ConvBatchNorm(in_channels + skip_channels, out_channels,
                                                  dtype),
                                    ConvBatchNorm(out_channels, out_channels, dtype))

    def forward(self, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = upsample2x_nearest(h)
        gated = self.coatt(up, skip, self.dtype)
        return self.nConvs(torch.cat([gated, up], dim=1))


class UCTransNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1, image_size: int = 224,
                 base_channel: int = 16, patch_sizes: Sequence[int] = (32, 16, 8, 4),
                 num_layers: int = 4, num_heads: int = 4, expand_ratio: int = 4,
                 vis: bool = False, dtype: torch.dtype = torch.float32,
                 bridge_pipeline: Optional[Any] = None):
        super().__init__()
        if bridge_pipeline is not None:
            raise ValueError(PIPELINE_REFUSAL)
        self.dtype = dtype
        self.vis = vis
        c = base_channel
        self.inc = ConvBatchNorm(in_channels, c, dtype)
        self.down1 = _NConvs(c, 2 * c, dtype)
        self.down2 = _NConvs(2 * c, 4 * c, dtype)
        self.down3 = _NConvs(4 * c, 8 * c, dtype)
        self.down4 = _NConvs(8 * c, 8 * c, dtype)
        self.mtc = ChannelTransformer((c, 2 * c, 4 * c, 8 * c), image_size, patch_sizes,
                                      num_layers, num_heads, expand_ratio, dtype)
        self.up4 = _UpBlockAttention(8 * c, 8 * c, 4 * c, dtype)
        self.up3 = _UpBlockAttention(4 * c, 4 * c, 2 * c, dtype)
        self.up2 = _UpBlockAttention(2 * c, 2 * c, c, dtype)
        self.up1 = _UpBlockAttention(c, c, c, dtype)
        self.outc = nn.Conv2d(c, num_classes, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H,
        W]}`` (and ``attn_weights`` with ``vis``). ``generator`` feeds the
        embeddings' and FFNs' dropout in training."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        x1 = self.inc(x)
        x2 = self.down1.nConvs(max_pool2d(x1, 2))
        x3 = self.down2.nConvs(max_pool2d(x2, 2))
        x4 = self.down3.nConvs(max_pool2d(x3, 2))
        x5 = self.down4.nConvs(max_pool2d(x4, 2))
        (x1, x2, x3, x4), weights = self.mtc([x1, x2, x3, x4], self.vis, generator)
        h = self.up4(x5, x4)
        h = self.up3(h, x3)
        h = self.up2(h, x2)
        h = self.up1(h, x1)
        out: Dict[str, Any] = {"main": conv(h, self.outc, self.dtype)}
        if self.vis:
            out["attn_weights"] = weights
        return out
