"""UNext / UNext-S (``unext``, ``unext_s``, ``unext_moe``). Counterpart of
``unet_zoo_tpu/models/unext.py``.

A three-stage tokenized encoder (overlap patch embedding, MiT blocks of
spatial-reduction attention and a depthwise-conv MLP, LayerNorm per stage)
and a conv decoder: bilinear (``align_corners=True``) resizes to the skip's
size, 3x3 convs, additive skips, then the 1x1 head and the x4 bilinear
upsample. Images come in NCHW and logits go out NCHW; the encoder keeps its
tokens channels-last, [B, H, W, C], so the Linears and the depthwise kernel
read them with no permute.

Module and attribute names follow the original PyTorch zoo
(``patch_embed{s}.{proj,norm}``, ``block{s}.{i}.{norm1,attn,norm2,mlp}``,
``attn.{q,kv,proj,sr,norm}``, ``mlp.{fc1,dwconv.dwconv,fc2}``, ``norm{s}``,
``decoder_level{1,2,3}``, ``final_conv``), so ``state_dict`` keys match what
``unet_zoo_tpu.utils.convert.convert_unext`` reads. Parameters are stored in
float32 and cast to the compute ``dtype`` at use.

Kernel (``use_kernels``, the shared rule of ``ops.kernels.use_kernel``): each
MiT block's ``DWConv`` runs K3, ``depthwise_conv2d``: 13 launches per
``unext`` forward (depths 3, 4, 6), 6 per ``unext_s``, 3 per ``unext_moe``.

``unext_moe`` is ``unext_s`` with ``moe_experts`` 4: block i of a stage
whose ``i % moe_every == moe_every - 1`` has the Switch-MoE FFN
(``block{s}.{i}.moe_mlp``, ``nn/moe.py``), which has no depthwise conv.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from unet_zoo_tpu_torch.nn import conv
from unet_zoo_tpu_torch.nn.transformer import MiTBlock, OverlapPatchEmbed, layer_norm
from unet_zoo_tpu_torch.ops import resize_bilinear


class UNext(nn.Module):
    """Returns ``{'main': logits [B, num_classes, H, W]}``; H and W multiples
    of 16 give the JAX package's shapes."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 embed_dims: Sequence[int] = (128, 160, 256),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 mlp_ratios: Sequence[float] = (4, 4, 4, 4),
                 depths: Sequence[int] = (3, 4, 6, 3), sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 qkv_bias: bool = False, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, moe_experts: int = 0, moe_every: int = 2,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        dims = list(embed_dims)
        depths = list(depths)[:3]
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        cur = 0
        for s in range(3):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_channels if s == 0 else dims[s - 1], dims[s],
                patch_size=7 if s == 0 else 3, stride=4 if s == 0 else 2, dtype=dtype))
            setattr(self, f"block{s + 1}", nn.ModuleList([MiTBlock(
                dims[s], num_heads[s], mlp_ratios[s], sr_ratios[s], qkv_bias, qk_scale,
                drop_rate, attn_drop_rate, dpr[cur + i],
                moe_experts if moe_experts and i % moe_every == moe_every - 1 else 0,
                dtype, use_kernels) for i in range(depths[s])]))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(dims[s], eps=1e-5))
            cur += depths[s]
        self.decoder_level1 = nn.Conv2d(dims[2], dims[1], 3, padding=1)
        self.decoder_level2 = nn.Conv2d(dims[1], dims[0], 3, padding=1)
        self.decoder_level3 = nn.Conv2d(dims[0], dims[0], 3, padding=1)
        self.final_conv = nn.Conv2d(dims[0], num_classes, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W]; ``generator`` feeds dropout and stochastic depth
        in training."""
        dt = self.dtype
        h = x.to(dtype=dt).permute(0, 2, 3, 1)
        feats = []
        for s in range(1, 4):
            h = getattr(self, f"patch_embed{s}")(h)
            for blk in getattr(self, f"block{s}"):
                h = blk(h, generator)
            h = layer_norm(h, getattr(self, f"norm{s}"))
            feats.append(h.permute(0, 3, 1, 2))                   # NCHW, channels_last
        x1, x2, x3 = feats

        u = resize_bilinear(x3, tuple(x2.shape[-2:]), align_corners=True)
        u = conv(u, self.decoder_level1, dt) + x2
        u = resize_bilinear(u, tuple(x1.shape[-2:]), align_corners=True)
        u = conv(u, self.decoder_level2, dt) + x1
        u = conv(u, self.decoder_level3, dt)
        # the 1x1 head before the x4 upsample (the JAX package's head-commute:
        # both are linear on disjoint axes and bilinear weights sum to 1)
        out = conv(u, self.final_conv, dt)
        out = resize_bilinear(out, (out.shape[-2] * 4, out.shape[-1] * 4), align_corners=True)
        return {"main": out}
