"""MMUNet: ConvNeXt-style multi-kernel split blocks (cascaded 3/5/7
depthwise convs over channel quarters), external attention in the deep
blocks, decoder blocks gated by softmax-maxpool dilation/erosion, and an
edge feature module (EFM) fused at full resolution. Counterpart of
``unet_zoo_tpu/models/mmunet.py``.

Module and attribute names follow the original PyTorch zoo
(``first_down.{0..4}``, ``up{u}.conv.{0..3}``, ``eam.up_x2.{1,2}``, ...), so
``state_dict`` keys match what ``unet_zoo_tpu.utils.convert`` reads.

Kernels (``use_kernels``, as in ``UpSampleUNet``: ``None`` runs them in eval
for bfloat16 CUDA activations; ``True`` in eval on any device, which on the
CPU means their plain versions; ``False`` never):

* every MKBlock's base (cascade + pointwise MLP + residual) runs K4,
  ``fused_mkblock``, on a bfloat16 copy of its input as the JAX package's
  fused path does; the external-attention tail stays in plain PyTorch, as
  the JAX package left it to XLA;
* every morphology gate runs K5, ``fused_softmax_morph``, on a bfloat16
  copy of its input, and returns the dilation and erosion in the model's
  dtype.

Shape gate: both kernels take any H and W; K4 takes channel counts that
are multiples of 32 and K5 multiples of 8 (whole 16-byte vectors of 8
channels). Other blocks take the module path. Every block and gate of the
registry's configurations (base_channels 96) passes it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import batch_norm, conv
from unet_zoo_tpu_torch.ops import max_pool2d, pad_to_match, resize_bilinear
from unet_zoo_tpu_torch.ops.kernels import mkblock, morph, use_kernel


def _linear(x: torch.Tensor, lin: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, lin.weight.to(dtype), None if lin.bias is None else lin.bias.to(dtype))


def softmax_morph(z: torch.Tensor, repeat: int, use_kernels: Optional[bool], training: bool):
    """softmax over C, then ``repeat`` rounds of 7x7 (dilate, erode): K5 on
    the kernel path (on a bfloat16 copy of ``z``, as MKBlock runs K4), else
    the plain chain of softmax and max pools."""
    if use_kernel(use_kernels, training, z, z.shape[1] % morph.CHANNEL_ALIGN == 0):
        zb = z.to(torch.bfloat16, memory_format=torch.channels_last)
        d, e = morph.fused_softmax_morph(zb, 7, repeat)
        return d.to(z.dtype), e.to(z.dtype)
    sm = torch.softmax(z, dim=1)
    d, e = sm, sm
    for _ in range(repeat):
        d = max_pool2d(d, 7, 1, 3)
        e = -max_pool2d(-e, 7, 1, 3)
    return d, e


class GroupedConv2in(nn.Conv2d):
    """3x3 conv with 2 input channels per group (EFM's Conv(2C -> C,
    groups=C)), no bias, on a [C, 2, 3, 3] weight.

    Computed as the JAX package does it: two depthwise convs, one over each
    interleaved channel half, summed. As one grouped conv it ran cuDNN's
    channels_last kernel for 2 inputs per group, which was the largest
    single kernel of the mmunet forward on the H100 (PERF.md)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(2 * features, features, 3, padding=1, groups=features, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        y0, y1 = (F.conv2d(x[:, i::2], w[:, i:i + 1], padding=1, groups=self.out_channels)
                  for i in range(2))
        return y0 + y1


class MKBlock(nn.Module):
    """Multi-kernel block: quarters -> cascaded dw3/5/7 + BN + GELU, fourth
    quarter passed through -> concat -> BN -> Linear 4C -> GELU -> Linear C
    -> + residual; with ``external_attention``, the Block1 tail (two k=64
    memory units, softmax over pixels, L1 over the memory axis)."""

    def __init__(self, dim: int, external_attention: bool = False,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        q = dim // 4
        self.dim, self.dtype, self.use_kernels = dim, dtype, use_kernels
        self.external_attention = external_attention
        for i, k in enumerate((3, 5, 7), start=1):
            setattr(self, f"dwconv{i}", nn.Conv2d(q, q, k, padding=k // 2, groups=q))
            setattr(self, f"norm{i}", nn.BatchNorm2d(q))
        self.norm4 = nn.BatchNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        if external_attention:
            self.norm_ea = nn.BatchNorm2d(dim)
            self.conv1 = nn.Conv2d(dim, dim, 1)
            self.linear_0 = nn.Conv1d(dim, 64, 1, bias=False)
            self.linear_1 = nn.Conv1d(64, dim, 1, bias=False)
            self.conv2 = nn.Sequential(nn.Conv2d(dim, dim, 1, bias=False), nn.BatchNorm2d(dim))
        self._frozen: Optional[mkblock.MKBlockWeights] = None
        self._packed: Optional[mkblock.MKBlockPacked] = None

    def kernel_path(self, x: torch.Tensor) -> bool:
        return use_kernel(self.use_kernels, self.training, x,
                          x.shape[1] % mkblock.CHANNEL_ALIGN == 0)

    def freeze_kernel_weights(self) -> None:
        """Fold and pack once for a predictor whose weights no longer change."""
        self._frozen = mkblock.fold_mkblock_params(self)
        self._packed = mkblock.pack_mkblock_weights(self._frozen.w1, self._frozen.w2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_path(x):
            w = self._frozen if self._frozen is not None else mkblock.fold_mkblock_params(self)
            xb = x.to(torch.bfloat16, memory_format=torch.channels_last)
            x = mkblock.fused_mkblock(xb, *w, packed=self._packed if self._frozen is not None
                                      else None).to(self.dtype)
        else:
            x = self._base(x)
        return self._attention(x) if self.external_attention else x

    def _base(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x1, x2, x3, x4 = x.split(self.dim // 4, dim=1)
        a = F.gelu(batch_norm(conv(x1, self.dwconv1, dt), self.norm1))
        b = F.gelu(batch_norm(conv(a + x2, self.dwconv2, dt), self.norm2))
        c = F.gelu(batch_norm(conv(b + x3, self.dwconv3, dt), self.norm3))
        h = batch_norm(torch.cat([a, b, c, x4], dim=1), self.norm4).permute(0, 2, 3, 1)
        h = _linear(F.gelu(_linear(h, self.pwconv1, dt)), self.pwconv2, dt)
        return x + h.permute(0, 3, 1, 2)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b, c, hh, ww = x.shape
        h = conv(batch_norm(x, self.norm_ea), self.conv1, dt)
        flat = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        attn = flat @ self.linear_0.weight[:, :, 0].t().to(dt)       # [b, n, 64]
        attn = torch.softmax(attn, dim=1)                              # over pixels
        attn = attn / (1e-9 + attn.sum(dim=2, keepdim=True))          # L1 over memory
        h = (attn @ self.linear_1.weight[:, :, 0].t().to(dt)).reshape(b, hh, ww, c)
        h = batch_norm(conv(h.permute(0, 3, 1, 2), self.conv2[0], dt), self.conv2[1])
        return F.gelu(x + h)


class Mlp(nn.Module):
    """1x1 conv -> GELU -> 1x1 conv (the Up block's shortcut)."""

    def __init__(self, channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Conv2d(channels, channels, 1)
        self.fc2 = nn.Conv2d(channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(F.gelu(conv(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class UpFuse(nn.Module):
    """Decoder block: bilinear x2 + pad, morphology-gated skip, 1x1 fuse conv
    + BN, two MKBlocks; ``with_mlp_shortcut`` adds the Mlp(x1 + x2) residual."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 with_mlp_shortcut: bool = False, use_block1: bool = False,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.use_kernels = dtype, use_kernels
        self.mlp = Mlp(skip_channels, out_channels, dtype) if with_mlp_shortcut else None
        self.linear1 = nn.Conv2d(skip_channels, skip_channels, 1)
        self.conv = nn.Sequential(
            nn.Conv2d(skip_channels + in_channels, out_channels, 1),
            nn.BatchNorm2d(out_channels),
            MKBlock(out_channels, use_block1, dtype, use_kernels),
            MKBlock(out_channels, use_block1, dtype, use_kernels))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x1 = resize_bilinear(x1, (2 * x1.shape[-2], 2 * x1.shape[-1]), align_corners=True)
        x1 = pad_to_match(x1, (x2.shape[-2], x2.shape[-1]))
        dilate, erode = softmax_morph(x2, 2, self.use_kernels, self.training)
        gated = (torch.sigmoid(conv(erode + x2, self.linear1, dt)) * x2
                 + torch.sigmoid(erode) * torch.tanh(dilate))
        fuse, bn, blk1, blk2 = self.conv
        h = blk2(blk1(batch_norm(conv(torch.cat([gated, x1], dim=1), fuse, dt), bn)))
        return h + self.mlp(x1 + x2) if self.mlp is not None else h


class _Blocks(nn.Module):
    """Holder of ``conv`` (the original zoo's ``up5``: two MKBlocks)."""

    def __init__(self, *blocks: nn.Module):
        super().__init__()
        self.conv = nn.Sequential(*blocks)


class EdgeFeatureModule(nn.Module):
    """The EFM's weights (``eam``): ``up_x2`` = (bilinear x2, grouped conv,
    BN) and ``linear1``, the 1x1 conv over both edge maps."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.up_x2 = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            GroupedConv2in(channels, dtype), nn.BatchNorm2d(channels))
        self.linear1 = nn.Conv2d(2 * channels, channels, 1)


class MMUNet(nn.Module):
    """``layer_scale_init_value`` and ``se_ratio`` are accepted for the
    registry's signature; the network uses neither, as in the JAX package."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1, bilinear: bool = True,
                 base_channels: int = 96, layer_scale_init_value: float = 1e-6,
                 se_ratio: float = 0.25, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.use_kernels = dtype, use_kernels
        bc = base_channels
        f = 2 if bilinear else 1

        def block(dim, ext=False):
            return MKBlock(dim, ext, dtype, use_kernels)

        def stage(cin, feats, k, stride, ext):
            return nn.Sequential(
                nn.Conv2d(cin, feats, k, stride, padding=3 if k == 7 else 0),
                nn.BatchNorm2d(feats), block(feats, ext), nn.BatchNorm2d(feats),
                block(feats, ext))

        self.first_down = stage(in_channels, bc, 7, 1, False)
        self.down0 = stage(bc, 2 * bc, 2, 2, False)
        self.down0_1 = stage(2 * bc, 2 * bc, 2, 2, False)
        self.down1 = stage(2 * bc, 4 * bc, 2, 2, False)
        self.down2 = stage(4 * bc, 8 * bc, 2, 2, True)
        self.down3 = stage(8 * bc, 16 * bc // f, 2, 2, True)
        self.up1 = UpFuse(16 * bc // f, 8 * bc, 8 * bc // f, True, True, dtype, use_kernels)
        self.up2 = UpFuse(8 * bc // f, 4 * bc, 4 * bc // f, True, True, dtype, use_kernels)
        self.up3 = UpFuse(4 * bc // f, 2 * bc, 2 * bc, False, False, dtype, use_kernels)
        self.up4 = UpFuse(2 * bc, 2 * bc, bc, False, False, dtype, use_kernels)
        self.up5 = _Blocks(block(bc), block(bc))
        self.eam = EdgeFeatureModule(bc, dtype)
        self.out_conv = nn.Sequential(nn.Conv2d(bc, num_classes, 1))

    def _stage(self, seq: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        c, bn1, blk1, bn2, blk2 = seq
        h = blk1(batch_norm(conv(h, c, self.dtype), bn1))
        return F.gelu(blk2(batch_norm(h, bn2)))

    def _edge(self, z: torch.Tensor) -> torch.Tensor:
        dilate, erode = softmax_morph(z, 1, self.use_kernels, self.training)
        return dilate - erode

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        dt = self.dtype
        x = x.to(dtype=dt, memory_format=torch.channels_last)
        x1 = self._stage(self.first_down, x)
        x2 = self._stage(self.down0, x1)
        x3 = self._stage(self.down0_1, x2)
        x4 = self._stage(self.down1, x3)
        x5 = self._stage(self.down2, x4)
        x6 = self._stage(self.down3, x5)

        u = self.up1(x6, x5)
        u = self.up2(u, x4)
        u = self.up3(u, x3)
        u = self.up4(u, x2)
        u = resize_bilinear(u, (2 * u.shape[-2], 2 * u.shape[-1]), align_corners=True)
        u = self.up5.conv(u)

        x2u = resize_bilinear(x2, (2 * x2.shape[-2], 2 * x2.shape[-1]), align_corners=True)
        _, gconv, bn = self.eam.up_x2
        x2u = F.gelu(batch_norm(gconv(x2u), bn))
        edges = torch.cat([self._edge(x2u), self._edge(x1)], dim=1)
        fused = u + conv(edges, self.eam.linear1, dt)
        return {"main": conv(fused, self.out_conv[0], dt)}
