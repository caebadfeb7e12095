"""EGE-UNet: grouped multi-axis Hadamard product attention (GHPA) in the
deeper encoder and decoder stages, and group aggregation bridges (GAB) that
fuse each skip with the deeper map and a deep-supervision mask. Counterpart
of ``unet_zoo_tpu/models/egeunet.py``; module names follow the original
EGE-UNet (``encoder{i}.0``, ``ebn{i}``, ``decoder{i}.0``, ``dbn{i}``,
``gt_conv{i}.0``, ``GAB{i}.{pre_project,g{k}.{0,1},tail_conv.{0,1}}``,
``final``; in a GHPA ``norm1``, ``norm2``, ``params_{xy,zx,zy}`` in the
original layouts [1, c, a, b] and [1, 1, c, L], ``conv_{xy,zx,zy}.{0,2}``,
``dw.{0,2}``, ``ldw.{0,2}``).

``image_size`` sets the GHPA grids' sizes (s / 8, s / 16, s / 32); each grid
is resized to the map it scales. Outputs ``{'main', 'side1'..'side5'}`` at
the input's size (with ``gt_ds``; ``main`` alone without). ``gt_ds=False``
feeds the bridges a mask of ones, as JAX does (the original crashes there).
No conv is int8-gated: every conv here is a plain conv in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import conv, group_norm
from unet_zoo_tpu_torch.ops import max_pool2d, resize_bilinear

# the dilations of GAB's four depthwise groups
GAB_DILATIONS = (1, 2, 5, 7)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of an NCHW map (eps 1e-6): statistics,
    normalisation and affine in float32, rounded once to the map's dtype, as
    Flax's ``LayerNorm`` computes them. Formed from ``var_mean`` over the
    channel axis (innermost in channels-last memory): ``F.layer_norm`` on
    these rows of 5-64 channels runs ATen's kernel of a block a row."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var, mean = torch.var_mean(xf, dim=1, correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


def _dw(channels: int, k: int = 3, dilation: int = 1, conv_t=nn.Conv2d) -> nn.Module:
    return conv_t(channels, channels, k, padding=dilation * (k // 2), dilation=dilation,
                  groups=channels)


class GHPA(nn.Module):
    """Four channel groups of the LayerNorm'd input: the first three times
    learned grids over (H, W), (C, H) and (C, W) (each resized bilinearly,
    ``align_corners``, then refined by a depthwise conv, exact GELU and a
    pointwise conv), the fourth through a 1x1 conv, GELU and a depthwise
    3x3; then concat, LayerNorm, a depthwise 3x3, GELU and a 1x1 conv to
    ``dim_out``. The grids start at ones."""

    def __init__(self, dim_in: int, dim_out: int, x_res: int = 8, y_res: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c = dim_in // 4
        self.params_xy = nn.Parameter(torch.ones(1, c, x_res, y_res))
        self.conv_xy = nn.Sequential(_dw(c), nn.GELU(), nn.Conv2d(c, c, 1))
        self.params_zx = nn.Parameter(torch.ones(1, 1, c, x_res))
        self.conv_zx = nn.Sequential(_dw(c, conv_t=nn.Conv1d), nn.GELU(), nn.Conv1d(c, c, 1))
        self.params_zy = nn.Parameter(torch.ones(1, 1, c, y_res))
        self.conv_zy = nn.Sequential(_dw(c, conv_t=nn.Conv1d), nn.GELU(), nn.Conv1d(c, c, 1))
        self.dw = nn.Sequential(nn.Conv2d(c, c, 1), nn.GELU(), _dw(c))
        self.norm1 = ChannelLayerNorm(dim_in)
        self.norm2 = ChannelLayerNorm(dim_in)
        self.ldw = nn.Sequential(_dw(dim_in), nn.GELU(), nn.Conv2d(dim_in, dim_out, 1))

    def _refine(self, grid: torch.Tensor, size, seq: nn.Sequential) -> torch.Tensor:
        g = resize_bilinear(grid.to(self.dtype), size, align_corners=True)
        if isinstance(seq[0], nn.Conv1d):
            g = g[0]                                           # [1, c, L]
        g = F.gelu(conv(g, seq[0], self.dtype))
        return conv(g, seq[2], self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        c = x.shape[1] // 4
        h, w = x.shape[-2:]
        x = self.norm1(x)
        x1, x2, x3, x4 = torch.split(x, c, dim=1)
        x1 = x1 * self._refine(self.params_xy, (h, w), self.conv_xy)         # [1, c, h, w]
        x2 = x2 * self._refine(self.params_zx, (c, h), self.conv_zx)[..., None]      # [1, c, h, 1]
        x3 = x3 * self._refine(self.params_zy, (c, w), self.conv_zy)[:, :, None, :]  # [1, c, 1, w]
        x4 = conv(F.gelu(conv(x4, self.dw[0], dt)), self.dw[2], dt)
        y = self.norm2(torch.cat([x1, x2, x3, x4], dim=1))
        y = F.gelu(conv(y, self.ldw[0], dt))
        return conv(y, self.ldw[2], dt)


class GAB(nn.Module):
    """Group aggregation bridge: the deeper map xh projected (1x1) to
    ``dim_xl`` channels and resized bilinearly (``align_corners``) to xl's
    map; four groups, each a quarter of xh's and of xl's channels and the
    1-channel mask, through a LayerNorm and a depthwise 3x3 dilated by
    GAB_DILATIONS; then concat, LayerNorm and a 1x1 conv to ``dim_xl``."""

    def __init__(self, dim_xh: int, dim_xl: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.pre_project = nn.Conv2d(dim_xh, dim_xl, 1)
        gc = dim_xl // 4 * 2 + 1
        for i, d in enumerate(GAB_DILATIONS):
            setattr(self, f"g{i}", nn.Sequential(ChannelLayerNorm(gc), _dw(gc, 3, d)))
        self.tail_conv = nn.Sequential(ChannelLayerNorm(gc * 4), nn.Conv2d(gc * 4, dim_xl, 1))

    def forward(self, xh: torch.Tensor, xl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        xh = conv(xh, self.pre_project, dt)
        xh = resize_bilinear(xh, tuple(xl.shape[-2:]), align_corners=True)
        xh_chunks = torch.chunk(xh, 4, dim=1)
        xl_chunks = torch.chunk(xl, 4, dim=1)
        outs = []
        for i in range(len(GAB_DILATIONS)):
            g = getattr(self, f"g{i}")
            z = g[0](torch.cat([xh_chunks[i], xl_chunks[i], mask], dim=1))
            outs.append(conv(z, g[1], dt))
        y = self.tail_conv[0](torch.cat(outs, dim=1))
        return conv(y, self.tail_conv[1], dt)


class EGEUNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 c_list: Optional[Sequence[int]] = None, bridge: bool = True, gt_ds: bool = True,
                 image_size: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bridge = bridge
        self.gt_ds = gt_ds
        c = list(c_list) if c_list is not None else [8, 16, 24, 32, 48, 64]
        s = image_size
        conv3 = lambda cin, cout: nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1))
        one = lambda m: nn.Sequential(m)
        self.encoder1 = conv3(in_channels, c[0])
        self.encoder2 = conv3(c[0], c[1])
        self.encoder3 = conv3(c[1], c[2])
        self.encoder4 = one(GHPA(c[2], c[3], s // 16, s // 16, dtype))
        self.encoder5 = one(GHPA(c[3], c[4], s // 32, s // 32, dtype))
        self.encoder6 = one(GHPA(c[4], c[5], s // 32, s // 32, dtype))
        if bridge:
            self.GAB1 = GAB(c[1], c[0], dtype=dtype)
            self.GAB2 = GAB(c[2], c[1], dtype=dtype)
            self.GAB3 = GAB(c[3], c[2], dtype=dtype)
            self.GAB4 = GAB(c[4], c[3], dtype=dtype)
            self.GAB5 = GAB(c[5], c[4], dtype=dtype)
        if gt_ds:
            for i, ch in enumerate((c[4], c[3], c[2], c[1], c[0])):
                setattr(self, f"gt_conv{i + 1}", one(nn.Conv2d(ch, 1, 1)))
        self.decoder1 = one(GHPA(c[5], c[4], s // 32, s // 32, dtype))
        self.decoder2 = one(GHPA(c[4], c[3], s // 16, s // 16, dtype))
        self.decoder3 = one(GHPA(c[3], c[2], s // 8, s // 8, dtype))
        self.decoder4 = conv3(c[2], c[1])
        self.decoder5 = conv3(c[1], c[0])
        for i, ch in enumerate(c[:5]):
            setattr(self, f"ebn{i + 1}", nn.GroupNorm(4, ch))
        for i, ch in enumerate((c[4], c[3], c[2], c[1], c[0])):
            setattr(self, f"dbn{i + 1}", nn.GroupNorm(4, ch))
        self.final = nn.Conv2d(c[0], num_classes, 1)

    def _stage(self, block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        m = block[0]
        return m(x) if isinstance(m, GHPA) else conv(x, m, self.dtype)

    def _mask(self, pre: Optional[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
        if self.gt_ds:
            return resize_bilinear(pre, tuple(target.shape[-2:]), align_corners=True)
        b, _, h, w = target.shape
        return torch.ones(b, 1, h, w, dtype=target.dtype, device=target.device)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main', 'side1'..'side5'}``
        logits [B, classes or 1, H, W] (``main`` alone without ``gt_ds``)."""
        dt = self.dtype
        x = x.to(dtype=dt, memory_format=torch.channels_last)
        up = lambda z, k=2: resize_bilinear(z, (k * z.shape[-2], k * z.shape[-1]),
                                            align_corners=True)
        t = []
        h = x
        for i in range(1, 6):
            h = group_norm(self._stage(getattr(self, f"encoder{i}"), h),
                           getattr(self, f"ebn{i}"))
            h = F.gelu(max_pool2d(h, 2))
            t.append(h)
        t.append(F.gelu(self._stage(self.encoder6, h)))
        t1, t2, t3, t4, t5, t6 = t

        sides = {}
        out5 = F.gelu(group_norm(self._stage(self.decoder1, t6), self.dbn1))
        pre5 = conv(out5, self.gt_conv1[0], dt) if self.gt_ds else None
        if self.bridge:
            t5 = self.GAB5(t6, t5, self._mask(pre5, t5))
        out = out5 + t5
        if self.gt_ds:
            sides["side5"] = up(pre5, 32)
        xh = t5
        # the bridges chain through the updated skips, not the decoder outputs
        for i, (skip, scale) in enumerate(((t4, 16), (t3, 8), (t2, 4), (t1, 2))):
            d = self._stage(getattr(self, f"decoder{i + 2}"), out)
            d = F.gelu(up(group_norm(d, getattr(self, f"dbn{i + 2}"))))
            pre = conv(d, getattr(self, f"gt_conv{i + 2}")[0], dt) if self.gt_ds else None
            if self.bridge:
                skip = getattr(self, f"GAB{4 - i}")(xh, skip, self._mask(pre, skip))
            xh = skip
            out = d + skip
            if self.gt_ds:
                sides[f"side{4 - i}"] = up(pre, scale)
        main = up(conv(out, self.final, dt))
        return {"main": main, **sides}
