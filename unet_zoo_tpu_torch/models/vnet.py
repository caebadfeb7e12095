"""VNet, 2D: an input stem with a residual of the repeated input, four down
and four up transitions of 5x5 conv units with residual adds, and a
"continuous" BatchNorm that always normalises by the batch's statistics.
Counterpart of ``unet_zoo_tpu/models/vnet.py``; module names follow the
original zoo (``in_tr``, ``down_tr{32,64,128,256}``,
``up_tr{256,128,64,32}``, ``out_tr``, each with ``conv1``/``down_conv``/
``up_conv``, ``bn1``, ``ops.{i}.{conv1,bn1}`` and, with ``elu=False``, the
PReLUs ``relu1``, ``relu2``, ``ops.{i}.relu1``).

``ContBatchNorm`` normalises with the batch's mean and biased variance in
eval as in training (the original zoo hard-codes ``training=True``), so a
served image's logits depend on the rest of its batch. It keeps no running
statistics: its ``state_dict`` holds its ``weight`` and ``bias`` alone, as
JAX's variables hold no ``batch_stats`` for it (the original zoo's
checkpoints carry running statistics that nothing reads). The stem tiles a
1-channel input to 16 channels, takes a 16-channel one as it is and runs a
1x1 conv (``in_tr.in_adapt``) on any other count. Channel dropout at 0.5
(whole channels of a sample) runs in training on ``down_tr128``'s and
``down_tr256``'s outputs, on ``up_tr256``'s and ``up_tr128``'s inputs and on
every skip, drawing from the forward's ``generator``. The last op is the
activation on the logits. No conv is int8-gated.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import TransposedUp, conv
from unet_zoo_tpu_torch.nn.blocks import global_batch_norm
from unet_zoo_tpu_torch.nn.transformer import dropout
from unet_zoo_tpu_torch.ops import pad_to_match
from unet_zoo_tpu_torch.parallel.global_batch import data_group

DROP_RATE = 0.5


class ContBatchNorm(nn.Module):
    """BatchNorm by the batch's statistics always (float32), affine: in
    eval too, so a data-parallel step or sharded predictor
    (``parallel.global_batch.data_group``) takes the global batch's."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = data_group()
        if group is not None:
            return global_batch_norm(x, self.weight.float(), self.bias.float(), 1e-5, group)[0]
        return F.batch_norm(x.float(), None, None, self.weight.float(), self.bias.float(),
                            True, 0.0, 1e-5).to(x.dtype)


def _act(elu: bool, channels: int) -> nn.Module:
    """ELU, or a per-channel PReLU (slopes at 0.25)."""
    return nn.ELU() if elu else nn.PReLU(channels, init=0.25)


def act(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """``module`` (from :func:`_act`) applied in ``x``'s dtype."""
    if isinstance(module, nn.PReLU):
        return F.prelu(x, module.weight.to(x.dtype))
    return F.elu(x)


class LUConv(nn.Module):
    """act(ContBatchNorm(conv5x5))."""

    def __init__(self, channels: int, elu: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, channels, 5, padding=2)
        self.bn1 = ContBatchNorm(channels)
        self.relu1 = _act(elu, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act(self.bn1(conv(x, self.conv1, self.dtype)), self.relu1)


class InputTransition(nn.Module):
    def __init__(self, in_channels: int, elu: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 16, 5, padding=2)
        self.bn1 = ContBatchNorm(16)
        if in_channels not in (1, 16):
            self.in_adapt = nn.Conv2d(in_channels, 16, 1)
        self.relu1 = _act(elu, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(conv(x, self.conv1, self.dtype))
        if x.shape[1] == 1:
            rep = x.expand(-1, 16, -1, -1)
        elif hasattr(self, "in_adapt"):
            rep = conv(x, self.in_adapt, self.dtype)
        else:
            rep = x
        return act(h + rep, self.relu1)


class DownTransition(nn.Module):
    """2x2/2 conv -> ContBatchNorm -> act (d); channel dropout when asked;
    ``n_convs`` LUConvs; act(that + d)."""

    def __init__(self, in_channels: int, out_channels: int, n_convs: int, elu: bool,
                 drop: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.drop = drop
        self.down_conv = nn.Conv2d(in_channels, out_channels, 2, stride=2)
        self.bn1 = ContBatchNorm(out_channels)
        self.relu1 = _act(elu, out_channels)
        self.ops = nn.Sequential(*(LUConv(out_channels, elu, dtype) for _ in range(n_convs)))
        self.relu2 = _act(elu, out_channels)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        d = act(self.bn1(conv(x, self.down_conv, self.dtype)), self.relu1)
        o = _channel_dropout(d, self.training, generator) if self.drop else d
        return act(self.ops(o) + d, self.relu2)


class UpTransition(nn.Module):
    """Channel dropout on the input when asked and on the skip always;
    2x2/2 transposed conv to ``out_channels // 2`` -> ContBatchNorm -> act;
    pad to the skip; concat[x, skip]; ``n_convs`` LUConvs; act(that +
    concat)."""

    def __init__(self, in_channels: int, out_channels: int, n_convs: int, elu: bool,
                 drop: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.drop = drop
        self.up_conv = TransposedUp(in_channels, out_channels // 2, dtype)
        self.bn1 = ContBatchNorm(out_channels // 2)
        self.relu1 = _act(elu, out_channels // 2)
        self.ops = nn.Sequential(*(LUConv(out_channels, elu, dtype) for _ in range(n_convs)))
        self.relu2 = _act(elu, out_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.drop:
            x = _channel_dropout(x, self.training, generator)
        skip = _channel_dropout(skip, self.training, generator)
        o = act(self.bn1(self.up_conv(x)), self.relu1)
        xcat = torch.cat([pad_to_match(o, (skip.shape[-2], skip.shape[-1])), skip], dim=1)
        return act(self.ops(xcat) + xcat, self.relu2)


class OutputTransition(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, elu: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, num_classes, 5, padding=2)
        self.bn1 = ContBatchNorm(num_classes)
        self.relu1 = _act(elu, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act(self.bn1(conv(x, self.conv1, self.dtype)), self.relu1)


def _channel_dropout(x: torch.Tensor, training: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    return dropout(x, DROP_RATE, training, generator, mask_shape=(*x.shape[:2], 1, 1))


class VNet(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 1, elu: bool = True,
                 nll: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.nll = nll   # accepted and unused, as in JAX
        self.in_tr = InputTransition(in_channels, elu, dtype)
        self.down_tr32 = DownTransition(16, 32, 1, elu, False, dtype)
        self.down_tr64 = DownTransition(32, 64, 2, elu, False, dtype)
        self.down_tr128 = DownTransition(64, 128, 3, elu, True, dtype)
        self.down_tr256 = DownTransition(128, 256, 2, elu, True, dtype)
        self.up_tr256 = UpTransition(256, 256, 2, elu, True, dtype)
        self.up_tr128 = UpTransition(256, 128, 2, elu, True, dtype)
        self.up_tr64 = UpTransition(128, 64, 1, elu, False, dtype)
        self.up_tr32 = UpTransition(64, 32, 1, elu, False, dtype)
        self.out_tr = OutputTransition(32, num_classes, elu, dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``.
        ``generator`` feeds the channel dropout in training."""
        x = x.to(dtype=self.dtype, memory_format=torch.channels_last)
        out16 = self.in_tr(x)
        out32 = self.down_tr32(out16, generator)
        out64 = self.down_tr64(out32, generator)
        out128 = self.down_tr128(out64, generator)
        out256 = self.down_tr256(out128, generator)
        u = self.up_tr256(out256, out128, generator)
        u = self.up_tr128(u, out64, generator)
        u = self.up_tr64(u, out32, generator)
        u = self.up_tr32(u, out16, generator)
        return {"main": self.out_tr(u)}
