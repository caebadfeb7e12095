"""MISSFormer (``missformer``). Counterpart of ``unet_zoo_tpu/models/missformer.py``.

A SegFormer-B1 MiT encoder (overlap patch embeddings, spatial-reduction
self-attention with biased q/kv, and MixFFN_skip: fc1, a 3x3 depthwise
conv, LayerNorm of the conv's output plus its input, exact GELU, fc2), a
4-layer multi-scale bridge (every stage's tokens projected to 64 channels
and concatenated; one single-head attention whose keys and values come from
per-scale strided reductions of the concatenated tokens; one MixFFN_skip a
scale; projections back to each stage's width) and a transformer decoder of
two MiT-style blocks a stage with PatchExpand (x2) and FinalPatchExpand_X4
(x4) upsampling. Images come in NCHW and logits go out NCHW; features stay
channels-last, [B, H, W, C], so the Linears and the depthwise kernel read
them with no permute. Grayscale input is tiled to 3 channels, and the first
patch embedding then takes 3.

Module and attribute names follow the original PyTorch zoo
(``backbone.{patch_embed,block,norm}{s}``, ``bridge.bridge_layer{l}`` with
``proj_c{c}``, ``attn.{q,kv,proj}``, ``attn.scale_reduce.{sr_convs.{i},norm}``
and ``mixffn{m}``, ``bridge.proj_back_c{c}``, ``decoder_{d}.{concat_linear,
layer_former_{1,2},layer_up.{expand,norm},last_layer}``, ``mlp.{fc1,
dwconv.dwconv,norm1,fc2}``), so ``state_dict`` keys match what
``unet_zoo_tpu.utils.convert.convert_missformer`` reads. Parameters are stored
in float32 and cast to the compute ``dtype`` at use.

Kernel (``use_kernels``, the shared rule of ``ops.kernels.use_kernel``): each
MixFFN_skip's ``DWConv`` runs K3, ``depthwise_conv2d``: 32 launches per
forward (8 in the encoder, 16 in the bridge, 8 in the decoder).

The last decoder stage runs its 1x1 head before the x4 depth-to-space in
eval (LayerNorm and the head act per output pixel, so only ``num_classes``
channels are rearranged) and after it in training, as JAX does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import conv
from unet_zoo_tpu_torch.nn.transformer import (
    DWConv,
    OverlapPatchEmbed,
    SRAttention,
    _nchw,
    _nhwc,
    layer_norm,
    linear,
)

B1_DIMS = (64, 128, 320, 512)
B1_LAYERS = (2, 2, 2, 2)
HEADS = (1, 2, 5, 8)
REDUCTION_RATIOS = (8, 4, 2, 1)


def _offsets(resolutions) -> List[int]:
    offsets = [0]
    for h, w in resolutions:
        offsets.append(offsets[-1] + h * w)
    return offsets


class MixFFNSkip(nn.Module):
    """fc1 -> DWConv -> LN(dw + fc1) -> exact GELU -> fc2 over [B, H, W, C]."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden, dtype, use_kernels)
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = linear(x, self.fc1, self.dtype)
        h = F.gelu(layer_norm(self.dwconv(h) + h, self.norm1))
        return linear(h, self.fc2, self.dtype)


class MFBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)) (biased q/kv), then x + MixFFN_skip(LN(x))."""

    def __init__(self, dim: int, head: int, reduction_ratio: int = 1,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SRAttention(dim, head, reduction_ratio, qkv_bias=True, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MixFFNSkip(dim, 4 * dim, dtype, use_kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))


class MiT(nn.Module):
    """Four stages (patch embedding, blocks, LayerNorm) returning [B, H, W, C]
    features at /4, /8, /16, /32."""

    def __init__(self, in_channels: int, dims: Sequence[int] = B1_DIMS,
                 layers: Sequence[int] = B1_LAYERS, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_channels if s == 0 else dims[s - 1], dims[s], patch_size=7 if s == 0 else 3,
                stride=4 if s == 0 else 2, dtype=dtype))
            setattr(self, f"block{s + 1}", nn.ModuleList([
                MFBlock(dims[s], HEADS[s], REDUCTION_RATIOS[s], dtype, use_kernels)
                for _ in range(layers[s])]))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(dims[s], eps=1e-5))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x)
            x = layer_norm(x, getattr(self, f"norm{s}"))
            outs.append(x)
        return outs


class ScaleReduce(nn.Module):
    """Each scale's slice of the concatenated tokens reduced by a stride-r r x r
    conv (r > 1; r = 1 as it is), concatenated again, then LayerNorm."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.sr_convs = nn.ModuleList([nn.Conv2d(dim, dim, r, r)
                                       for r in REDUCTION_RATIOS if r > 1])
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, resolutions) -> torch.Tensor:
        b, _, c = x.shape
        off = _offsets(resolutions)
        reduced = []
        for i, ((h, w), r) in enumerate(zip(resolutions, REDUCTION_RATIOS)):
            t = x[:, off[i]:off[i + 1]].reshape(b, h, w, c)
            if r > 1:
                t = _nhwc(conv(_nchw(t), self.sr_convs[i], self.dtype))
            reduced.append(t.flatten(1, 2))
        return layer_norm(torch.cat(reduced, dim=1), self.norm)


class MultiScaleReduceAttention(nn.Module):
    """Queries over the concatenated multi-scale tokens [B, N, C]; keys and
    values from their per-scale reductions (``scale_reduce``); softmax and
    products in the compute type."""

    def __init__(self, dim: int, head: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head, self.dtype = head, dtype
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.scale_reduce = ScaleReduce(dim, dtype)

    def forward(self, x: torch.Tensor, resolutions) -> torch.Tensor:
        b, n, c = x.shape
        nh, dt = self.head, self.dtype
        hd = c // nh
        q = linear(x, self.q, dt).reshape(b, n, nh, hd)
        kv = linear(self.scale_reduce(x, resolutions), self.kv, dt).reshape(b, -1, 2, nh, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, c)
        return linear(out, self.proj, dt)


class BridgeLayer4(nn.Module):
    """One bridge layer over the concatenated tokens of the four scales; the
    first projects each stage's [B, H, W, C_s] features to ``dims[0]`` first."""

    def __init__(self, dims: Sequence[int], head: int, project_in: bool,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.project_in = dtype, project_in
        cdim = dims[0]
        if project_in:
            for i, d in enumerate(dims):
                setattr(self, f"proj_c{i + 1}", nn.Linear(d, cdim))
        self.norm1 = nn.LayerNorm(cdim, eps=1e-5)
        self.attn = MultiScaleReduceAttention(cdim, head, dtype)
        self.norm2 = nn.LayerNorm(cdim, eps=1e-5)
        for m in range(1, 5):
            setattr(self, f"mixffn{m}", MixFFNSkip(cdim, 4 * cdim, dtype, use_kernels))

    def forward(self, inputs, resolutions) -> torch.Tensor:
        if self.project_in:
            cat = torch.cat([linear(f, getattr(self, f"proj_c{i + 1}"), self.dtype).flatten(1, 2)
                             for i, f in enumerate(inputs)], dim=1)
        else:
            cat = inputs
        tx1 = cat + self.attn(layer_norm(cat, self.norm1), resolutions)
        tx = layer_norm(tx1, self.norm2)
        b, _, c = tx.shape
        off = _offsets(resolutions)
        outs = [getattr(self, f"mixffn{i + 1}")(tx[:, off[i]:off[i + 1]].reshape(b, h, w, c)
                                               ).flatten(1, 2)
                for i, (h, w) in enumerate(resolutions)]
        return tx1 + torch.cat(outs, dim=1)


class BridgeBlock4(nn.Module):
    """Four bridge layers, then each scale's tokens projected back to its
    stage's width: [B, H_s, W_s, C_s] features in, the same shapes out."""

    def __init__(self, dims: Sequence[int] = B1_DIMS, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        for i in range(1, 5):
            setattr(self, f"bridge_layer{i}",
                    BridgeLayer4(dims, HEADS[0], i == 1, dtype, use_kernels))
        for i, d in enumerate(dims):
            setattr(self, f"proj_back_c{i + 1}", nn.Linear(dims[0], d))

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        res = [(f.shape[1], f.shape[2]) for f in feats]
        h = self.bridge_layer1(feats, res)
        for i in range(2, 5):
            h = getattr(self, f"bridge_layer{i}")(h, res)
        off = _offsets(res)
        b = h.shape[0]
        return [linear(h[:, off[i]:off[i + 1]], getattr(self, f"proj_back_c{i + 1}"), self.dtype
                       ).reshape(b, hh, ww, -1) for i, (hh, ww) in enumerate(res)]


def patch_expand_rearrange(x: torch.Tensor, p: int, c_out: int) -> torch.Tensor:
    """[B, H, W, p * p * c_out] -> [B, H * p, W * p, c_out] (depth to space,
    each pixel's channels one contiguous slice)."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, p, p, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p, w * p, c_out)


class PatchExpand(nn.Module):
    """x2 upsampling: Linear(dim -> 4 dim, no bias), depth to space, LayerNorm."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.expand = nn.Linear(dim, 4 * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = patch_expand_rearrange(linear(x, self.expand, self.dtype), 2, self.dim)
        return layer_norm(x, self.norm)


class FinalPatchExpandX4(nn.Module):
    """x4 upsampling: Linear(dim -> 16 dim, no bias), depth to space,
    LayerNorm. ``defer_rearrange`` returns the grouped [B, H, W, 16, dim]
    view with the LayerNorm applied to each output pixel, the same numbers
    before the rearrange."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, defer_rearrange: bool = False) -> torch.Tensor:
        x = linear(x, self.expand, self.dtype)
        if defer_rearrange:
            b, h, w, _ = x.shape
            return layer_norm(x.reshape(b, h, w, 16, self.dim), self.norm)
        return layer_norm(patch_expand_rearrange(x, 4, self.dim), self.norm)


class SegUDecoder(nn.Module):
    """concat(x1, skip) -> Linear (when there is a skip), two MFBlocks, then
    PatchExpand, or on the last stage FinalPatchExpand_X4 and the 1x1 head."""

    def __init__(self, in_dim: int, out_dim: int, head: int, reduction_ratio: int,
                 num_classes: int = 1, is_last: bool = False, concat: bool = True,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.is_last, self.num_classes = dtype, is_last, num_classes
        if concat:
            self.concat_linear = nn.Linear(in_dim, out_dim)
        self.layer_former_1 = MFBlock(out_dim, head, reduction_ratio, dtype, use_kernels)
        self.layer_former_2 = MFBlock(out_dim, head, reduction_ratio, dtype, use_kernels)
        if is_last:
            self.layer_up = FinalPatchExpandX4(out_dim, dtype)
            self.last_layer = nn.Conv2d(out_dim, num_classes, 1)
        else:
            self.layer_up = PatchExpand(out_dim, dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The 1x1 head over the last axis."""
        w, b = self.last_layer.weight, self.last_layer.bias
        return F.linear(x, w.reshape(w.shape[0], -1).to(self.dtype), b.to(self.dtype))

    def forward(self, x1: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x1
        if skip is not None:
            h = linear(torch.cat([x1, skip], dim=-1), self.concat_linear, self.dtype)
        h = self.layer_former_2(self.layer_former_1(h))
        if not self.is_last:
            return self.layer_up(h)
        if self.training:
            return self.head(self.layer_up(h))
        out = self.head(self.layer_up(h, defer_rearrange=True))      # [B, H, W, 16, classes]
        return patch_expand_rearrange(out.flatten(3), 4, self.num_classes)


class MISSFormer(nn.Module):
    """Returns ``{'main': logits [B, num_classes, H, W]}``; H and W multiples
    of 32 give the JAX package's shapes."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        d = B1_DIMS
        self.backbone = MiT(3 if in_channels == 1 else in_channels, d, B1_LAYERS, dtype,
                            use_kernels)
        self.bridge = BridgeBlock4(d, dtype, use_kernels)
        self.decoder_3 = SegUDecoder(d[3], d[3], HEADS[3], REDUCTION_RATIOS[3], concat=False,
                                     dtype=dtype, use_kernels=use_kernels)
        self.decoder_2 = SegUDecoder(d[3] + d[2], d[2], HEADS[2], REDUCTION_RATIOS[2],
                                     dtype=dtype, use_kernels=use_kernels)
        self.decoder_1 = SegUDecoder(d[2] + d[1], d[1], HEADS[1], REDUCTION_RATIOS[1],
                                     dtype=dtype, use_kernels=use_kernels)
        self.decoder_0 = SegUDecoder(d[1] + d[0], d[0], HEADS[0], REDUCTION_RATIOS[0],
                                     num_classes=num_classes, is_last=True, dtype=dtype,
                                     use_kernels=use_kernels)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W]."""
        h = x.to(dtype=self.dtype).permute(0, 2, 3, 1)
        if h.shape[-1] == 1:
            h = h.repeat(1, 1, 1, 3)
        sk = self.bridge(self.backbone(h))
        h = self.decoder_3(sk[3])
        h = self.decoder_2(h, sk[2])
        h = self.decoder_1(h, sk[1])
        return {"main": self.decoder_0(h, sk[0]).permute(0, 3, 1, 2)}
