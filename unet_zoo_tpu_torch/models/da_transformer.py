"""DA-Transformer: a ResNetV2 encoder (pre-activation bottlenecks,
weight-standardised convs, GroupNorm) and a decoder whose first three
stages apply dual attention: PAM, a position attention at a pooled
resolution (64 x 64 or 32 x 32 tokens), and CAM, a channel attention.
Counterpart of ``unet_zoo_tpu/models/da_transformer.py``; module names
follow the original zoo (``resnet.root.{conv,gn}``,
``resnet.body.block{b}.unit{u}.{conv1-3,gn1-3,downsample,gn_proj}``,
``bottleneck.conv_op``, ``up_block{u}.{up,skip_conv,conv.conv_op}``,
``pam{i}.{query,key,value}_conv``, ``pam{i}.gamma``, ``cam{i}.gamma``,
``up_block{5,6}.1``, ``outc``).

The bottleneck's and the four ``UpSampleDA`` stages' double convs (10
convs) are int8-gated. The six attention gammas start at zero, so a freshly
drawn model adds nothing of either attention. The final resize goes to the
input's size, as in JAX (the original zoo fixes it at 512). ``DANetHead`` is
the original zoo's unused DANet head, kept as JAX keeps it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from unet_zoo_tpu_torch.nn import DoubleConv, TransposedUp, batch_norm, conv, group_norm
from unet_zoo_tpu_torch.nn.transformer import dropout
from unet_zoo_tpu_torch.ops import adaptive_avg_pool2d, max_pool2d, pad_to_match, resize_bilinear


def get_da_transformer_config() -> Dict[str, Any]:
    """The default config, as a plain dict (JAX's ``get_da_transformer_config``).
    Only ``resnet.num_layers`` and ``resnet.width_factor`` reach the model."""
    return {
        "patches": {"size": (16, 16), "grid": (16, 16)},
        "hidden_size": 768,
        "transformer": {
            "mlp_dim": 3072,
            "num_heads": 12,
            "num_layers": 12,
            "attention_dropout_rate": 0.0,
            "dropout_rate": 0.1,
        },
        "classifier": "seg",
        "representation_size": None,
        "resnet_pretrained_path": None,
        "pretrained_path": None,
        "patch_size": 16,
        "resnet": {"num_layers": (3, 4, 9), "width_factor": 1},
        "decoder_channels": (256, 128, 64, 16),
        "skip_channels": [512, 256, 64, 16],
        "n_classes": 2,
        "n_skip": 3,
        "activation": "softmax",
    }


class StdConv(nn.Conv2d):
    """A weight-standardised conv without bias: each output channel's kernel
    less its mean over (ci, kh, kw), over its biased standard deviation
    (eps 1e-5), formed in float32 and cast once to ``dtype``; autograd runs
    through the standardisation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         bias=False)
        self.dtype = dtype

    def standardised_weight(self) -> torch.Tensor:
        w = self.weight.to(torch.promote_types(self.weight.dtype, torch.float32))
        var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0, keepdim=True)
        return ((w - mean) * torch.rsqrt(var + 1e-5)).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.standardised_weight(), None)


class PreActBottleneck(nn.Module):
    """conv1x1 -> GN -> ReLU -> conv3x3(stride) -> GN -> ReLU -> conv1x1 ->
    GN, plus the input (through a 1x1 StdConv(stride) and a per-channel GN
    where the shape changes), then ReLU. GroupNorm(32) at eps 1e-6 (Flax's
    default); ``gn_proj`` has a group a channel at eps 1e-5."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if stride != 1 or cin != cout:
            self.downsample = StdConv(cin, cout, 1, stride, 0, dtype)
            self.gn_proj = nn.GroupNorm(cout, cout, eps=1e-5)
        else:
            self.downsample = None
        self.conv1 = StdConv(cin, cmid, 1, 1, 0, dtype)
        self.gn1 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = StdConv(cmid, cmid, 3, stride, 1, dtype)
        self.gn2 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv3 = StdConv(cmid, cout, 1, 1, 0, dtype)
        self.gn3 = nn.GroupNorm(32, cout, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.downsample is not None:
            residual = group_norm(self.downsample(x), self.gn_proj)
        y = torch.relu(group_norm(self.conv1(x), self.gn1))
        y = torch.relu(group_norm(self.conv2(y), self.gn2))
        y = group_norm(self.conv3(y), self.gn3)
        return torch.relu(residual + y)


class _Root(nn.Module):
    def __init__(self, in_channels: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.conv = StdConv(in_channels, width, 7, 2, 3, dtype)
        self.gn = nn.GroupNorm(32, width, eps=1e-6)


class ResNetV2(nn.Module):
    """The root (7x7 stride-2 StdConv, GN, ReLU, 3x3 stride-2 max pool with
    padding 0, floor mode: 63 x 63 maps from 256px), then three stages of
    ``block_units`` bottlenecks to 4, 8 and 16 times ``width`` channels, the
    second and third starting at stride 2. Returns ``(e3, [e3, e2, e1,
    stem])``."""

    def __init__(self, in_channels: int = 3, block_units: Sequence[int] = (3, 4, 9),
                 width_factor: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(64 * width_factor)
        self.width = width
        self.root = _Root(in_channels, width, dtype)
        body = {}
        cin = width
        for bi, (cout, cmid) in enumerate([(width * 4, width), (width * 8, width * 2),
                                           (width * 16, width * 4)]):
            units = {}
            for ui in range(block_units[bi]):
                stride = 2 if (bi > 0 and ui == 0) else 1
                units[f"unit{ui + 1}"] = PreActBottleneck(cin, cout, cmid, stride, dtype)
                cin = cout
            body[f"block{bi + 1}"] = nn.ModuleDict(units)
        self.body = nn.ModuleDict(body)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, list]:
        h = torch.relu(group_norm(self.root.conv(x), self.root.gn))
        h = max_pool2d(h, 3, 2, padding=0)
        stem = h
        e = []
        for block in self.body.values():
            for unit in block.values():
                h = unit(h)
            e.append(h)
        return e[2], [e[2], e[1], e[0], stem]


class DAPam(nn.Module):
    """Position attention at ``attn_res`` tokens: q, k (C / 8) and v (C) 1x1
    convs, each adaptive-average-pooled to ``attn_res`` (up-sizing where the
    map is smaller), unscaled q.k logits, softmax over the keys, P.V, a
    bilinear resize back (``align_corners``), times ``gamma`` (zero at init),
    plus the input."""

    def __init__(self, channels: int, attn_res: Tuple[int, int] = (64, 64),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn_res = tuple(attn_res)
        self.query_conv = nn.Conv2d(channels, channels // 8, 1)
        self.key_conv = nn.Conv2d(channels, channels // 8, 1)
        self.value_conv = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dt, res = self.dtype, self.attn_res
        q = adaptive_avg_pool2d(conv(x, self.query_conv, dt), res).flatten(2)   # [B, C/8, N]
        k = adaptive_avg_pool2d(conv(x, self.key_conv, dt), res).flatten(2)
        v = adaptive_avg_pool2d(conv(x, self.value_conv, dt), res).flatten(2)   # [B, C, N]
        attn = torch.softmax(q.transpose(1, 2) @ k, dim=-1)   # [B, N (query), N (key)]
        out = (v @ attn.transpose(1, 2)).view(b, c, *res)
        out = resize_bilinear(out, (h, w), align_corners=True)
        return self.gamma.to(x.dtype) * out + x


class DACam(nn.Module):
    """Channel attention: energies X^T X over the positions, softmax over
    the channels of (row max - energy), applied to X, times ``gamma`` (zero
    at init), plus the input. The energies and their softmax are formed in
    float32 (a bf16 energy keeps 8 bits of a sum over H W positions, and the
    softmax of max - energy is near one-hot), cast once to the input's type."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = x.flatten(2)                                    # [B, C, N]
        f32 = flat.to(torch.promote_types(flat.dtype, torch.float32))
        energy = f32 @ f32.transpose(1, 2)                     # [B, C, C]
        attn = torch.softmax(energy.amax(dim=-1, keepdim=True) - energy, dim=-1)
        out = (attn.to(x.dtype) @ flat).view(b, c, h, w)
        return self.gamma.to(x.dtype) * out + x


class _ConvBNReLU(nn.Sequential):
    """The original zoo's conv3x3 (no bias) -> BatchNorm (eps 1e-3, Flax
    momentum 0.05) -> ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         nn.BatchNorm2d(cout, eps=1e-3, momentum=0.95), nn.ReLU())


class _Head(nn.Sequential):
    """Dropout (0.05) -> 1x1 conv, then ReLU (as JAX's head applies it)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Dropout(0.05), nn.Conv2d(cin, cout, 1))


class DANetHead(nn.Module):
    """The classic DANet head (unused by ``DATransformer``, as in the
    original zoo): PAM and CAM branches over 3x3-conv-reduced features
    (C / 16), fused by addition into ``conv8``; ``conv6`` and ``conv7``, the
    branch heads, are built always and returned with ``return_aux``.
    ``generator`` feeds the heads' dropout in training."""

    def __init__(self, in_channels: int, out_channels: int,
                 attn_res: Tuple[int, int] = (64, 64), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        inter = in_channels // 16
        self.conv5a = _ConvBNReLU(in_channels, inter)
        self.conv5c = _ConvBNReLU(in_channels, inter)
        self.sa = DAPam(inter, attn_res, dtype)
        self.sc = DACam()
        self.conv51 = _ConvBNReLU(inter, inter)
        self.conv52 = _ConvBNReLU(inter, inter)
        self.conv6 = _Head(inter, out_channels)
        self.conv7 = _Head(inter, out_channels)
        self.conv8 = _Head(inter, out_channels)

    def _cbr(self, x: torch.Tensor, m: _ConvBNReLU) -> torch.Tensor:
        return torch.relu(batch_norm(conv(x, m[0], self.dtype), m[1]))

    def _head(self, x: torch.Tensor, m: _Head, generator: Optional[torch.Generator]
              ) -> torch.Tensor:
        x = dropout(x, m[0].p, self.training, generator)
        return torch.relu(conv(x, m[1], self.dtype))

    def forward(self, x: torch.Tensor, return_aux: bool = False,
                generator: Optional[torch.Generator] = None):
        sa = self._cbr(self.sa(self._cbr(x, self.conv5a)), self.conv51)
        sc = self._cbr(self.sc(self._cbr(x, self.conv5c)), self.conv52)
        out = self._head(sa + sc, self.conv8, generator)
        sa_out = self._head(sa, self.conv6, generator)
        sc_out = self._head(sc, self.conv7, generator)
        if return_aux:
            return out, sa_out, sc_out
        return out


class UpSampleDA(nn.Module):
    """ConvTranspose 2x2 stride 2 -> a 1x1 ``skip_conv`` on the skip -> pad
    or crop the upsampled map to the skip's size -> concat[x, skip] -> the
    int8-gated :class:`DoubleConv`."""

    def __init__(self, in_channels: int, skip_channels: int, up_channels: int,
                 out_channels: int, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.up = TransposedUp(in_channels, up_channels, dtype)
        self.skip_conv = nn.Conv2d(skip_channels, up_channels, 1)
        self.conv = DoubleConv(2 * up_channels, out_channels, dtype, use_kernels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        skip = conv(skip, self.skip_conv, self.dtype)
        x = pad_to_match(x, (skip.shape[-2], skip.shape[-1]))
        return self.conv(torch.cat([x, skip], dim=1))


def _upsample_conv(cin: int, cout: int) -> nn.Sequential:
    """The original zoo's bilinear x2 (``align_corners``) -> conv3x3 -> ReLU."""
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
                         nn.Conv2d(cin, cout, 3, padding=1), nn.ReLU())


class DATransformer(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 block_units: Sequence[int] = (3, 4, 9), width_factor: int = 1,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.resnet = ResNetV2(in_channels, block_units, width_factor, dtype)
        w = self.resnet.width
        args = (dtype, use_kernels)
        self.bottleneck = DoubleConv(w * 16, 1024, *args)
        self.up_block1 = UpSampleDA(1024, w * 16, 512, 512, *args)
        self.pam1, self.cam1 = DAPam(512, (64, 64), dtype), DACam()
        self.up_block2 = UpSampleDA(512, w * 8, 256, 256, *args)
        self.pam2, self.cam2 = DAPam(256, (64, 64), dtype), DACam()
        self.up_block3 = UpSampleDA(256, w * 4, 128, 128, *args)
        self.pam3, self.cam3 = DAPam(128, (32, 32), dtype), DACam()
        self.up_block4 = UpSampleDA(128, w, 64, 64, *args)
        self.up_block5 = _upsample_conv(64, 32)
        self.up_block6 = _upsample_conv(32, 32)
        self.outc = nn.Conv2d(32, num_classes, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        in_hw = x.shape[-2:]
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        # the skips, and the attentions' outputs (NCHW-contiguous maps), in
        # channels_last memory, which the int8 convs they feed read in place
        cl = torch.channels_last
        _, skips = self.resnet(x)
        skips = [s.contiguous(memory_format=cl) for s in skips]
        h = self.bottleneck(skips[0])
        h = self.cam1(self.pam1(self.up_block1(h, skips[0]))).contiguous(memory_format=cl)
        h = self.cam2(self.pam2(self.up_block2(h, skips[1]))).contiguous(memory_format=cl)
        h = self.cam3(self.pam3(self.up_block3(h, skips[2]))).contiguous(memory_format=cl)
        h = self.up_block4(h, skips[3])
        for block in (self.up_block5, self.up_block6):
            h = resize_bilinear(h, (2 * h.shape[-2], 2 * h.shape[-1]), align_corners=True)
            h = torch.relu(conv(h, block[1], self.dtype))
        h = resize_bilinear(h, tuple(in_hw), align_corners=True)
        return {"main": conv(h, self.outc, self.dtype)}
