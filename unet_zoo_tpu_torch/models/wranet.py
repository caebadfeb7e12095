"""WRANet (``wranet``). Counterpart of ``unet_zoo_tpu/models/wranet.py``.

Wide-receptive-field attention net: LiteWRARB blocks (streams of 1-4
depthwise-separable blocks, an SE-style gate and a zero-init per-channel
``alpha`` residual), strided-conv downsampling, and PixelShuffle decoders
that end in a deformable-conv residual block. NCHW in ``channels_last``
memory throughout; the deformable conv reads its input, offsets and mask as
channels-last [B, H, W, C] views.

Module and attribute names follow the original PyTorch zoo
(``convblock_1.{0,1}``, ``encoder_block_{e}.lite_wragb.{streams,project,ag,
alpha}``, ``encoder_block_{e}.conv_3x3``, ``down{1,2}``,
``decoder_lv{2,1}.{pixelshuffle_block,conv_3x3_last,rdb}``,
``rdb.convs.0.{offset_conv,modulator_conv,conv}``, ``rdb.last_conv``,
``last_conv.{0,1,2}``), so ``state_dict`` keys match what
``unet_zoo_tpu.utils.convert.convert_wranet`` reads. Parameters are stored
in float32 and cast to the compute ``dtype`` at use.

Kernel (``use_kernels``, the shared rule of ``ops.kernels.use_kernel``: in
eval only, the JAX package has no backward for it): each ``DeformableConv``
runs K8, ``deform_conv2d``, 2 launches per forward. The module path is
``ops/deform.py::deform_conv2d``, the JAX package's XLA path. The depthwise
convs of ``ModifiedDSCB`` stay ``nn.Conv2d(groups=C)``: the JAX package runs
them as a grouped conv, not through its depthwise kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import batch_norm, conv
from unet_zoo_tpu_torch.ops import deform as module_deform
from unet_zoo_tpu_torch.ops.kernels import deform as k8
from unet_zoo_tpu_torch.ops.kernels import use_kernel


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d``'s default (no affine, no running statistics):
    float32 mean and biased variance over H and W, in x's type out."""
    x32 = x.float()
    mu = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """torch's PixelShuffle (channels read as [C_out, r, r]), channels_last out."""
    return F.pixel_shuffle(x, r).contiguous(memory_format=torch.channels_last)


class BasicConv(nn.Sequential):
    """conv -> norm ('instance', 'batch' or none) -> ReLU (if ``act``).
    Keys: ``0`` the conv, ``1`` the BatchNorm when there is one."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, norm: str = "instance",
                 act: bool = True, dtype: torch.dtype = torch.float32):
        layers = [nn.Conv2d(in_channels, features, kernel_size, stride, padding, bias=use_bias)]
        if norm == "batch":
            layers.append(nn.BatchNorm2d(features, eps=1e-5, momentum=0.1))
        super().__init__(*layers)
        self.dtype, self.norm, self.act = dtype, norm, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(x, self[0], self.dtype)
        if self.norm == "instance":
            x = instance_norm(x)
        elif self.norm == "batch":
            x = batch_norm(x, self[1])
        return torch.relu(x) if self.act else x


class ModifiedDSCB(nn.Module):
    """depthwise 3x3 -> 1x1 -> InstanceNorm -> ReLU, no biases."""

    def __init__(self, channels: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dw_conv = nn.Conv2d(channels, channels, 3, padding=1, groups=channels, bias=False)
        self.conv_1x1 = nn.Conv2d(channels, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(conv(x, self.dw_conv, self.dtype), self.conv_1x1, self.dtype)
        return torch.relu(instance_norm(x))


class LiteWRARB(nn.Module):
    """Streams of 1, 2, 3 and 4 ModifiedDSCBs, concatenated and projected
    (1x1 conv, InstanceNorm, ReLU), times an SE gate (1x1 convs C -> C/16 ->
    C, ReLU, sigmoid), plus ``alpha`` [1, C, 1, 1] (zero at init) times x."""

    def __init__(self, channels: int, num_blocks_list: Sequence[int] = (1, 2, 3, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.streams = nn.ModuleList([
            nn.Sequential(*[ModifiedDSCB(channels, channels, dtype) for _ in range(nb)])
            for nb in num_blocks_list])
        self.project = BasicConv(channels * len(num_blocks_list), channels, kernel_size=1,
                                 use_bias=False, dtype=dtype)
        self.ag = nn.Sequential(nn.Conv2d(channels, channels // 16, 1), nn.ReLU(),
                                nn.Conv2d(channels // 16, channels, 1), nn.Sigmoid())
        self.alpha = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        proj = self.project(torch.cat([s(x) for s in self.streams], dim=1))
        g = torch.sigmoid(conv(torch.relu(conv(proj, self.ag[0], dt)), self.ag[2], dt))
        return self.alpha.to(dt) * x + proj * g


class EncoderBlock(nn.Module):
    """LiteWRARB, then a 3x3 BasicConv (InstanceNorm, ReLU)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lite_wragb = LiteWRARB(channels, dtype=dtype)
        self.conv_3x3 = BasicConv(channels, channels, kernel_size=3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_3x3(self.lite_wragb(x))


class DeformableConv(nn.Module):
    """Modulated deformable conv whose offsets (2 k^2 channels) and mask
    (sigmoid, k^2 channels) come from k x k convs of the input, both
    initialised to zero; ``conv`` holds the deformable weight [O, C, k, k]
    and bias.

    Kernel path (the shared rule, eval only): K8, ``deform_conv2d``, on
    channels-last views of the input, offsets and mask. Module path:
    ``ops/deform.py::deform_conv2d``. Both take the weight as [k, k, C, O]
    and the bias in the compute type, as the JAX module casts them."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 1, use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        k, p = kernel_size, (kernel_size - 1) // 2
        self.stride, self.padding = stride, padding
        self.dtype, self.use_kernels = dtype, use_kernels
        self.offset_conv = nn.Conv2d(in_channels, 2 * k * k, k, stride, p)
        self.modulator_conv = nn.Conv2d(in_channels, k * k, k, stride, p)
        for m in (self.offset_conv, self.modulator_conv):
            m.init_gain = 0.0                              # zero at init, as in JAX
        self.conv = nn.Conv2d(in_channels, features, k, bias=use_bias)
        self._frozen = None

    def kernel_path(self, x: torch.Tensor) -> bool:
        return use_kernel(self.use_kernels, self.training, x)

    @torch.no_grad()
    def deform_weights(self):
        """The weight as [k, k, C, O] and the bias, in the compute type."""
        b = self.conv.bias
        return (self.conv.weight.permute(2, 3, 1, 0).to(self.dtype).contiguous(),
                None if b is None else b.to(self.dtype))

    def freeze_kernel_weights(self) -> None:
        """Lay out the weight once for a predictor whose weights no longer change."""
        self._frozen = self.deform_weights()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        offset = conv(x, self.offset_conv, dt)
        mask = torch.sigmoid(conv(x, self.modulator_conv, dt))
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()   # a view when channels_last
        if self.kernel_path(x):
            weight, bias = self._frozen if self._frozen is not None else self.deform_weights()
            out = k8.deform_conv2d(nhwc(x), nhwc(offset), nhwc(mask), weight, bias,
                                   self.stride, self.padding)
        else:
            weight = self.conv.weight.permute(2, 3, 1, 0).to(dt)
            bias = None if self.conv.bias is None else self.conv.bias.to(dt)
            out = module_deform.deform_conv2d(nhwc(x), nhwc(offset), nhwc(mask), weight, bias,
                                              self.stride, self.padding)
        return out.permute(0, 3, 1, 2)


@torch.no_grad()
def draw_offsets(module: nn.Module, offset_scale: float, mask_scale: float, seed: int) -> None:
    """The offset and modulator convs of every DeformableConv in ``module``
    drawn off their zero init (std ``offset_scale`` and ``mask_scale`` over
    sqrt(fan_in), biases unchanged) from one CPU generator: at init the
    deformable conv is a plain conv times 0.5 and never exercises the
    gather. Every model built from the same seed gets the same values."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, DeformableConv):
            for conv_m, scale in ((m.offset_conv, offset_scale), (m.modulator_conv, mask_scale)):
                std = scale / conv_m.weight[0].numel() ** 0.5
                conv_m.weight.copy_(std * torch.randn(conv_m.weight.shape, generator=g))


class DeformableResblock(nn.Module):
    """x + conv3x3(relu(deform_conv(x)))."""

    def __init__(self, channels: int, mid_features: int, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList([DeformableConv(channels, mid_features, use_bias=True,
                                                   dtype=dtype, use_kernels=use_kernels)])
        self.last_conv = nn.Conv2d(mid_features, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + conv(torch.relu(self.convs[0](x)), self.last_conv, self.dtype)


class WRADecoder(nn.Module):
    """3x3 conv to 4 * features -> PixelShuffle 2 -> concat with the skip ->
    3x3 BasicConv (BatchNorm, ReLU) -> DeformableResblock (features / 4 mid)."""

    def __init__(self, in_channels: int, skip_channels: int, features: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.pixelshuffle_block = nn.Sequential(
            nn.Conv2d(in_channels, features * 4, 3, padding=1, bias=False), nn.PixelShuffle(2))
        self.conv_3x3_last = BasicConv(features + skip_channels, features, kernel_size=3,
                                       padding=1, norm="batch", dtype=dtype)
        self.rdb = DeformableResblock(features, features // 4, dtype, use_kernels)

    def forward(self, x_small: torch.Tensor, x_large: torch.Tensor) -> torch.Tensor:
        up = _pixel_shuffle(conv(x_small, self.pixelshuffle_block[0], self.dtype), 2)
        return self.rdb(self.conv_3x3_last(torch.cat([up, x_large], dim=1)))


class WRANet(nn.Module):
    """Returns ``{'main': logits [B, num_classes, H, W]}``; H and W multiples
    of 4."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1, feature_channels: int = 128,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        fc, self.dtype = feature_channels, dtype
        self.convblock_1 = nn.Sequential(nn.Conv2d(in_channels, fc // 2, 3, padding=1),
                                         nn.Conv2d(fc // 2, fc, 3, padding=1))
        for e in (1, 2, 3):
            setattr(self, f"encoder_block_{e}", EncoderBlock(fc, dtype))
        self.down1 = nn.Conv2d(fc, fc, 3, 2, 1, bias=False)
        self.down2 = nn.Conv2d(fc, fc, 3, 2, 1, bias=False)
        self.decoder_lv2 = WRADecoder(fc, fc, fc, dtype, use_kernels)
        self.decoder_lv1 = WRADecoder(fc, fc, fc, dtype, use_kernels)
        self.last_conv = nn.Sequential(nn.Conv2d(fc, fc // 2, 3, padding=1),
                                       nn.Conv2d(fc // 2, fc // 4, 3, padding=1),
                                       nn.Conv2d(fc // 4, num_classes, 3, padding=1))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        dt = self.dtype
        h = x.to(dtype=dt, memory_format=torch.channels_last)
        h = conv(conv(h, self.convblock_1[0], dt), self.convblock_1[1], dt)
        lv1 = self.encoder_block_1(h)
        lv2 = self.encoder_block_2(conv(lv1, self.down1, dt))
        lv3 = self.encoder_block_3(conv(lv2, self.down2, dt))
        d2 = self.decoder_lv2(lv3, lv2)
        d1 = self.decoder_lv1(d2, lv1)
        for m in self.last_conv:
            d1 = conv(d1, m, dt)
        return {"main": d1}
