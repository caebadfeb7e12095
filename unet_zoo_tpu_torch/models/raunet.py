"""RAUNet: a ResNet-34 encoder, LinkNet decoder blocks and attention
aggregation (AAM) of each decoder output with its skip. Counterpart of
``unet_zoo_tpu/models/raunet.py``; module names follow the original zoo
(the encoder's ``firstconv``, ``firstbn``, ``encoder{1-4}``, then
``decoder{4-1}``, ``gau{3-1}``, ``finaldeconv1``, ``finalconv2``,
``finalconv3``).

The registry overlays the encoder with pretrained weights by default
(``models/__init__.py``). With ``num_classes > 1`` the output is
``log_softmax`` over the classes, as in the original zoo. No conv is
int8-gated.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import batch_norm, conv, conv_transpose
from unet_zoo_tpu_torch.nn.blocks import _bn
from unet_zoo_tpu_torch.nn.resnet import ResNet34Encoder
from unet_zoo_tpu_torch.ops import global_avg_pool

FILTERS = (64, 128, 256, 512)


class AAM(nn.Module):
    """Attention aggregation: a channel weight, the softmax over channels of
    conv3(squeeze(high) + squeeze(low)), each squeeze a global average pool,
    a 1x1 conv, a LayerNorm over the channels and a ReLU; it scales
    ReLU(InstanceNorm(conv4(low))) (no affine, float32), which is added to
    ``high``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name in ("conv1", "conv2"):
            setattr(self, name, nn.Sequential(nn.Conv2d(in_channels, out_channels, 1),
                                              nn.LayerNorm([out_channels, 1, 1]),
                                              nn.ReLU(inplace=True)))
        self.conv3 = nn.Sequential(nn.Conv2d(out_channels, out_channels, 1), nn.Softmax(dim=1))
        self.conv4 = nn.Sequential(nn.Conv2d(in_channels, out_channels, 1), nn.ReLU(inplace=True))

    def _squeeze(self, z: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
        z = conv(global_avg_pool(z), seq[0], self.dtype)
        ln = seq[1]
        z = F.layer_norm(z.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                         ln.eps)
        return torch.relu(z).to(self.dtype)

    def forward(self, high: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        weight = self._squeeze(high, self.conv1) + self._squeeze(low, self.conv2)
        weight = torch.softmax(conv(weight, self.conv3[0], dt).float(), dim=1).to(dt)
        lo = conv(low, self.conv4[0], dt)
        lo32 = lo.float()
        var, mu = torch.var_mean(lo32, dim=(2, 3), keepdim=True, correction=0)
        lo = torch.relu(((lo32 - mu) * torch.rsqrt(var + 1e-5)).to(lo.dtype))
        return high + lo * weight


class DecoderBlockLinkNet(nn.Module):
    """1x1 conv to a quarter of the channels, 4x4 transposed conv (stride 2,
    padding 1: twice the size), 1x1 conv to ``n_filters``; BN and ReLU after
    each."""

    def __init__(self, in_channels: int, n_filters: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        mid = in_channels // 4
        self.conv1 = nn.Conv2d(in_channels, mid, 1)
        self.norm1 = _bn(mid)
        self.deconv2 = nn.ConvTranspose2d(mid, mid, 4, stride=2, padding=1)
        self.norm2 = _bn(mid)
        self.conv3 = nn.Conv2d(mid, n_filters, 1)
        self.norm3 = _bn(n_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.relu(batch_norm(conv(x, self.conv1, dt), self.norm1))
        h = torch.relu(batch_norm(conv_transpose(h, self.deconv2, dt), self.norm2))
        return torch.relu(batch_norm(conv(h, self.conv3, dt), self.norm3))


class RAUNet(ResNet34Encoder):
    """The encoder's modules are RAUNet's own, as the original zoo takes
    torchvision's resnet34 modules as its attributes."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 dtype: torch.dtype = torch.float32):
        if in_channels != 3:
            raise ValueError(f"RAUNet requires in_channels == 3, got {in_channels}")
        super().__init__(in_channels, dtype)
        self.num_classes = num_classes
        f = FILTERS
        self.decoder4 = DecoderBlockLinkNet(f[3], f[2], dtype)
        self.decoder3 = DecoderBlockLinkNet(f[2], f[1], dtype)
        self.decoder2 = DecoderBlockLinkNet(f[1], f[0], dtype)
        self.decoder1 = DecoderBlockLinkNet(f[0], f[0], dtype)
        self.gau3 = AAM(f[2], f[2], dtype)
        self.gau2 = AAM(f[1], f[1], dtype)
        self.gau1 = AAM(f[0], f[0], dtype)
        # the head: 2n + 1 (3x3 transposed, stride 2), - 2 (3x3), + 1 (2x2,
        # padding 1): twice decoder1's input, the image's size
        self.finaldeconv1 = nn.ConvTranspose2d(f[0], 32, 3, stride=2)
        self.finalconv2 = nn.Conv2d(32, 32, 3)
        self.finalconv3 = nn.Conv2d(32, num_classes, 2, padding=1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, 3, H, W] images; returns ``{'main': logits [B, classes, H, W]}``
        (log-probabilities when ``num_classes > 1``)."""
        dt = self.dtype
        x = x.to(dtype=dt, memory_format=torch.channels_last)
        e1, e2, e3, e4 = self.encode(x)
        b4 = self.gau3(self.decoder4(e4), e3)
        b3 = self.gau2(self.decoder3(b4), e2)
        b2 = self.gau1(self.decoder2(b3), e1)
        d1 = self.decoder1(b2)
        h = torch.relu(conv_transpose(d1, self.finaldeconv1, dt))
        h = torch.relu(conv(h, self.finalconv2, dt))
        out = conv(h, self.finalconv3, dt)
        if self.num_classes > 1:
            out = torch.log_softmax(out, dim=1)
        return {"main": out}
