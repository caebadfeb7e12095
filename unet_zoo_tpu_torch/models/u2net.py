"""U²-Net and U²-Net-small (``u2netp``): a 6-stage encoder and 5-stage decoder
of nested RSU blocks, six side heads fused by a 1x1 conv. Counterpart of
``unet_zoo_tpu/models/u2net.py``; module names follow the original zoo
(``stage{n}[d]``, ``rebnconv*.{conv_s1,bn_s1}``, ``side{i}``, ``outconv``).

* pooling is 2x2 in ceil mode, upsampling bilinear (``align_corners=False``)
  to the size of the feature it meets, which at odd inputs is no power-of-two
  ratio;
* RSU-L (L = 7..4) is a small UNet of L levels with a dilation-2 top conv,
  RSU-4F a fully dilated one (dilations 1, 2, 4, 8, no pooling);
* the six 3x3 side heads are resized to side1's size and fused by ``outconv``.

Outputs ``{'main', 'side1'..'side6'}`` at unit loss weights. Every REBNCONV
conv is int8-gated, as in JAX, and ``make_predictor(quant=...)`` serves all
112 of them through P2, the dilated ones (2, 4, 8) included.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import conv, conv_norm_act
from unet_zoo_tpu_torch.ops import max_pool2d, resize_bilinear

# (levels or "F", mid, out) of the encoder and decoder stages
STAGES = {
    False: ([(7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512), ("F", 256, 512),
             ("F", 256, 512)],
            [("F", 256, 512), (4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64)]),
    True: ([(7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64), ("F", 16, 64), ("F", 16, 64)],
           [("F", 16, 64), (4, 16, 64), (5, 16, 64), (6, 16, 64), (7, 16, 64)]),
}


def _up_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(src, tuple(tar.shape[-2:]), align_corners=False)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return max_pool2d(x, 2, ceil_mode=True)


class REBNCONV(nn.Module):
    """conv3x3 (dilation and padding ``dirate``) -> BN -> ReLU, int8-gated."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int, dtype: torch.dtype,
                 use_kernels: Optional[bool]):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate, dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_norm_act(x, self.conv_s1, self.bn_s1, self.dtype, self.use_kernels)


class RSU(nn.Module):
    """RSU-L: ``rebnconvin``, encoder convs 1..L-1 with a ceil-mode pool after
    all but the last, the dilation-2 top conv L, decoder convs (L-1)d..1d on
    ``[h, enc]``; returns the decoder's output plus ``rebnconvin``'s."""

    def __init__(self, levels: int, in_ch: int, mid_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.levels = levels
        blk = lambda i, o, d=1: REBNCONV(i, o, d, dtype, use_kernels)
        self.rebnconvin = blk(in_ch, out_ch)
        for i in range(1, levels):
            setattr(self, f"rebnconv{i}", blk(out_ch if i == 1 else mid_ch, mid_ch))
        setattr(self, f"rebnconv{levels}", blk(mid_ch, mid_ch, 2))
        for i in range(levels - 1, 0, -1):
            setattr(self, f"rebnconv{i}d", blk(2 * mid_ch, out_ch if i == 1 else mid_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        enc, h = [], hxin
        for i in range(1, self.levels):
            h = getattr(self, f"rebnconv{i}")(h)
            enc.append(h)
            if i < self.levels - 1:
                h = _pool(h)
        h = getattr(self, f"rebnconv{self.levels}")(enc[-1])
        for i in range(self.levels - 1, 0, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, enc[i - 1]], dim=1))
            if i > 1:
                h = _up_like(h, enc[i - 2])
        return h + hxin


class RSU4F(nn.Module):
    """The fully dilated RSU: dilations 1, 2, 4, 8 up and 4, 2, 1 down."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        blk = lambda i, o, d: REBNCONV(i, o, d, dtype, use_kernels)
        self.rebnconvin = blk(in_ch, out_ch, 1)
        self.rebnconv1 = blk(out_ch, mid_ch, 1)
        self.rebnconv2 = blk(mid_ch, mid_ch, 2)
        self.rebnconv3 = blk(mid_ch, mid_ch, 4)
        self.rebnconv4 = blk(mid_ch, mid_ch, 8)
        self.rebnconv3d = blk(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = blk(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = blk(2 * mid_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], dim=1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], dim=1))
        return self.rebnconv1d(torch.cat([h2d, h1], dim=1)) + hxin


class U2Net(nn.Module):
    """U²-Net; ``small=True`` gives U2NETP (every mid 16, every out 64)."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1, small: bool = False,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        stages, dstages = STAGES[small]

        def make(kind, cin, mid, out):
            if kind == "F":
                return RSU4F(cin, mid, out, dtype, use_kernels)
            return RSU(kind, cin, mid, out, dtype, use_kernels)

        cin = in_channels
        for i, (kind, mid, out) in enumerate(stages):
            setattr(self, f"stage{i + 1}", make(kind, cin, mid, out))
            cin = out
        for i, (kind, mid, out) in enumerate(dstages):
            # [the stage below (upsampled), the encoder stage of this level]
            setattr(self, f"stage{5 - i}d", make(kind, cin + stages[4 - i][2], mid, out))
            cin = out
        side_in = [dstages[4 - i][2] for i in range(5)] + [stages[5][2]]
        for i, ch in enumerate(side_in):
            setattr(self, f"side{i + 1}", nn.Conv2d(ch, num_classes, 3, padding=1))
        self.outconv = nn.Conv2d(6 * num_classes, num_classes, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main', 'side1'..'side6'}`` logits [B, classes, H, W]."""
        h = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        enc = []
        for i in range(6):
            h = getattr(self, f"stage{i + 1}")(h)
            enc.append(h)
            if i < 5:
                h = _pool(h)
        h = _up_like(enc[5], enc[4])
        dec = []                       # hx5d, hx4d, hx3d, hx2d, hx1d
        for i in range(5):
            h = getattr(self, f"stage{5 - i}d")(torch.cat([h, enc[4 - i]], dim=1))
            dec.append(h)
            if i < 4:
                h = _up_like(h, enc[3 - i])
        feats = [dec[4], dec[3], dec[2], dec[1], dec[0], enc[5]]
        sides = [conv(f, getattr(self, f"side{i + 1}"), self.dtype) for i, f in enumerate(feats)]
        sides = [sides[0]] + [_up_like(s, sides[0]) for s in sides[1:]]
        out = {"main": conv(torch.cat(sides, dim=1), self.outconv, self.dtype)}
        out.update((f"side{i + 1}", s) for i, s in enumerate(sides))
        return out
