"""Encoder/decoder blocks of the classic UNet (NCHW, channels_last memory).

Counterparts of ``unet_zoo_tpu/nn/blocks.py``. Module and attribute names
follow the original PyTorch zoo (``conv_op.{0,1,3,4}``, ``up``, ``conv``),
so ``state_dict`` keys match what ``unet_zoo_tpu.utils.convert`` reads.

Parameters are stored in float32 and cast to the block's compute ``dtype``
at use, as Flax does with ``param_dtype=float32, dtype=...``: rounding the
stored parameters to bfloat16 (``utils.serving.cast_params_for_inference``)
changes their values, not the compute type. BatchNorm always normalises in
float32 and returns the compute type.

Train-mode BatchNorm (:func:`batch_norm`) follows Flax, not
``nn.BatchNorm2d``: it normalises with the biased batch variance and
updates ``running_var`` with the biased one too (decay 0.9, i.e. torch
momentum 0.1), where ``F.batch_norm`` would update it with the unbiased.

Every :func:`conv_norm_act` conv and :class:`ResidualConv`'s three convs
are int8-gated (:func:`gated_conv`), as the JAX package's
``conv_maybe_int8`` (``nn/blocks.py:104-141``): inside
:func:`recording_conv_inputs` it records ``max |x|`` of its input in float32
(calibration); in eval, once :func:`attach_int8` has given it quantised
weights (``conv.int8``, an attribute outside the ``state_dict``, as JAX keeps
the ``quant`` collection apart from the float parameters), it runs int8.
Training ignores them. The int8 conv (P2) takes 3x3 convs with padding 1 and
stride 1 or 2: :func:`attach_int8` refuses any other gated conv by name (a
dilated or a 1x1 one, which JAX serves int8), so no model is served partly
int8 and partly float. K1's fused decoder stage reads the float weights and
ignores them too, as ``UpSampleUNet._fused`` does in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.ops import (max_pool2d, pad_to_match, quant, resize_bilinear,
                                    upsample2x_nearest)
from unet_zoo_tpu_torch.ops.kernels import int8_gemm, use_kernel
from unet_zoo_tpu_torch.ops.kernels.fused_up import (
    fold_conv_bn,
    fused_up_concat_conv,
    pack_conv3x3_kernel,
    pack_convt_kernel,
    pack_kernel_weights,
)


def conv(x: torch.Tensor, module: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``module``'s convolution (stride, padding, groups) computed in ``dtype``."""
    bias = None if module.bias is None else module.bias.to(dtype)
    return module._conv_forward(x, module.weight.to(dtype), bias)


def conv_transpose(x: torch.Tensor, module: nn.ConvTranspose2d, dtype: torch.dtype
                   ) -> torch.Tensor:
    """``module``'s transposed convolution (stride, padding) computed in ``dtype``."""
    bias = None if module.bias is None else module.bias.to(dtype)
    return F.conv_transpose2d(x, module.weight.to(dtype), bias, module.stride, module.padding,
                              module.output_padding, module.groups, module.dilation)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """``bn`` on a ``dtype`` input: float32 statistics and affine, so it
    normalises in float32 and returns the input's type.

    In eval it applies the running statistics. In training it normalises
    with the batch mean and biased variance over every axis but 1, then
    updates the running statistics as Flax's ``BatchNorm`` does
    (``unet_zoo_tpu/nn/blocks.py:36-46``) with the *biased* variance (see
    :func:`update_running_stats`). ``F.batch_norm`` hands its batch mean
    and unbiased variance out through momentum-1 buffers; the biased
    variance is the latter times (n - 1) / n. An affine-less ``bn``
    (``affine=False``, JAX's ``use_scale=False, use_bias=False``) has no
    weight or bias.
    """
    weight = None if bn.weight is None else bn.weight.float()
    bias = None if bn.bias is None else bn.bias.float()
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, weight, bias, False, 0.0,
                            bn.eps)
    mean = torch.zeros_like(bn.running_mean)
    var = torch.ones_like(bn.running_var)
    y = F.batch_norm(x, mean, var, weight, bias, True, 1.0, bn.eps)
    n = x.numel() // x.shape[1]
    update_running_stats(bn, mean, var * ((n - 1) / n))
    return y


def update_running_stats(bn: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
    """Flax's running-statistics update from a batch's mean and biased
    variance: ``r = (1 - m) r + m s`` with ``m = bn.momentum`` (0.1, Flax's
    decay 0.9), in float32."""
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - m).add_(mean.reshape(-1).float() * m)
        bn.running_var.mul_(1.0 - m).add_(var.reshape(-1).float() * m)
        bn.num_batches_tracked.add_(1)


class Int8Conv(NamedTuple):
    """A gated conv's int8 serving weights, quantised once (:func:`prepare_int8_conv`)."""

    wp: torch.Tensor              # [Co, Kpad] int8 (int8_gemm.pack_conv_weight)
    s_x: torch.Tensor             # 0-dim float32 activation scale
    scale: torch.Tensor           # [Co] float32, s_x * s_w
    bias: Optional[torch.Tensor]  # [Co] float32
    stride: int


def prepare_int8_conv(conv_m: nn.Conv2d, absmax: torch.Tensor, name: str) -> Int8Conv:
    """Quantise ``conv_m``'s weight (as served: already bf16-rounded by a
    bf16 cast) per output channel and take the activation scale from the
    calibrated ``absmax``. Raises, naming the conv ``name``, for a conv that
    the int8 conv kernel does not take."""
    if (conv_m.kernel_size != (3, 3) or conv_m.padding != (1, 1) or conv_m.groups != 1
            or conv_m.dilation != (1, 1) or conv_m.stride not in ((1, 1), (2, 2))):
        raise ValueError(f"{name}: the int8 conv takes 3x3 convs with padding 1 and stride 1 "
                         f"or 2, not {conv_m}")
    k = conv_m.weight.detach()
    s_w = quant.weight_scale(k)
    s_x = quant.activation_scale(absmax.detach().to(k.device))
    bias = None if conv_m.bias is None else conv_m.bias.detach().float().contiguous()
    return Int8Conv(int8_gemm.pack_conv_weight(quant.quantize_weight(k, s_w)), s_x,
                    (s_x * s_w).contiguous(), bias, conv_m.stride[0])


def int8_conv(x: torch.Tensor, q: Int8Conv, dtype: torch.dtype,
              use_kernels: Optional[bool] = None) -> torch.Tensor:
    """The int8 conv of NCHW ``x`` (``_QuantConv``): ``x`` quantised per
    tensor by ``q.s_x``, the int8 conv, dequantised and rounded to
    ``dtype``. With ``use_kernels`` None the kernel (P2) takes any CUDA
    input, float32 or bfloat16, and quantises x as it loads it (a
    channels-last x is read in place); ``False`` runs the plain version, as
    ``True`` does on the CPU."""
    xh = x.permute(0, 2, 3, 1)
    if use_kernel(use_kernels, False, x, dtypes=(torch.float32, torch.bfloat16)):
        y = int8_gemm.int8_conv3x3(xh, q.s_x, q.wp, q.scale, q.bias, q.stride, dtype)
    else:
        y = int8_gemm.int8_conv3x3_reference(xh, q.s_x, q.wp, q.scale, q.bias, q.stride, dtype)
    return y.permute(0, 3, 1, 2)


# The calibration record ({conv module: max |x| so far}) while
# recording_conv_inputs is open, else None.
_RECORD: Optional[Dict[nn.Module, torch.Tensor]] = None


@contextlib.contextmanager
def recording_conv_inputs() -> Iterator[Dict[nn.Module, torch.Tensor]]:
    """Within, every :func:`conv_norm_act` conv records ``max |x|`` of its
    input in float32 into the yielded dict (the maximum over the forwards)."""
    global _RECORD
    saved, _RECORD = _RECORD, {}
    try:
        yield _RECORD
    finally:
        _RECORD = saved


def attach_int8(module: nn.Module, stats: Mapping[str, torch.Tensor]) -> None:
    """Quantise each conv named in ``stats`` ({module name: calibrated
    absmax}, from ``utils.serving.calibrate_int8``) once, from its current
    weights: its eval forwards then run int8. Raises for a conv the int8
    kernel does not take (:func:`prepare_int8_conv`), before any is served."""
    for name, absmax in stats.items():
        conv_m = module.get_submodule(name)
        if not isinstance(conv_m, nn.Conv2d):
            raise ValueError(f"{name} is a {type(conv_m).__name__}, not an int8-gated conv")
        conv_m.int8 = prepare_int8_conv(conv_m, torch.as_tensor(absmax, dtype=torch.float32),
                                        name)


def gated_conv(x: torch.Tensor, conv_m: nn.Conv2d, dtype: torch.dtype,
               use_kernels: Optional[bool] = None) -> torch.Tensor:
    """``conv_m`` on ``x``, int8-gated (module docstring; ``use_kernels`` as
    :func:`int8_conv`): records ``max |x|`` inside :func:`recording_conv_inputs`
    and runs int8 in eval once :func:`attach_int8` has quantised it."""
    if _RECORD is not None:
        m = x.detach().float().abs().amax()
        prev = _RECORD.get(conv_m)
        _RECORD[conv_m] = m if prev is None else torch.maximum(prev, m)
    q = getattr(conv_m, "int8", None)
    if q is not None and not conv_m.training:
        return int8_conv(x, q, dtype, use_kernels)
    return conv(x, conv_m, dtype)


def conv_norm_act(x: torch.Tensor, conv_m: nn.Conv2d, bn: nn.BatchNorm2d,
                  dtype: torch.dtype, use_kernels: Optional[bool] = None,
                  act: Optional[str] = "relu") -> torch.Tensor:
    """conv -> BatchNorm -> activation (the JAX package's ``ConvNormAct``),
    the conv int8-gated (:func:`gated_conv`); ``act`` names a ``torch``
    function, None leaves the BN output as it is.

    A function over the two modules rather than a module of its own, so
    that ``DoubleConv`` keeps the original zoo's flat ``conv_op`` indices.
    """
    x = batch_norm(gated_conv(x, conv_m, dtype, use_kernels), bn)
    return x if act is None else getattr(torch, act)(x)


def _bn(channels: int, affine: bool = True) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1, affine=affine)


class ConvNormAct(nn.Module):
    """conv(k, stride, dilation) -> BN -> activation (:func:`conv_norm_act`;
    JAX ``ConvNormAct``), padded to keep the size. ``bn_affine=False`` is a
    BN without weight or bias. The int8 kernel takes only the 3x3 ones
    (:func:`prepare_int8_conv`)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None,
                 dilation: int = 1, kernel_size: int = 3, act: Optional[str] = "relu",
                 bn_affine: bool = True):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.act = act
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=dilation * (kernel_size // 2), dilation=dilation)
        self.bn = _bn(out_channels, bn_affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_norm_act(x, self.conv, self.bn, self.dtype, self.use_kernels, self.act)


def _double_conv(in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None) -> nn.Sequential:
    """The original zoo's (conv3x3 -> BN -> ReLU) x 2 Sequential, through
    ``mid_channels`` (``out_channels`` if None)."""
    mid_channels = out_channels if mid_channels is None else mid_channels
    return nn.Sequential(
        nn.Conv2d(in_channels, mid_channels, 3, padding=1),
        _bn(mid_channels),
        nn.ReLU(inplace=True),
        nn.Conv2d(mid_channels, out_channels, 3, padding=1),
        _bn(out_channels),
        nn.ReLU(inplace=True),
    )


def double_conv_norm_act(x: torch.Tensor, op: nn.Sequential, dtype: torch.dtype,
                         use_kernels: Optional[bool] = None) -> torch.Tensor:
    """A :func:`_double_conv` Sequential on ``x``, both convs int8-gated."""
    x = conv_norm_act(x, op[0], op[1], dtype, use_kernels)
    return conv_norm_act(x, op[3], op[4], dtype, use_kernels)


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) x 2, both convs int8-gated."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.conv_op = _double_conv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return double_conv_norm_act(x, self.conv_op, self.dtype, self.use_kernels)


class ConvBlock(nn.Module):
    """``DoubleConv`` as the original zoo's Attention UNet names it
    (``conv.{0,1,3,4}``; JAX ``ConvBlock``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.conv = _double_conv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return double_conv_norm_act(x, self.conv, self.dtype, self.use_kernels)


class DoubleConvMid(nn.Module):
    """conv3x3 -> BN -> ReLU to ``mid_channels``, then to ``out_channels``,
    both convs int8-gated (JAX ``DoubleConvMid``; the original zoo's
    ``VGGBlock`` names ``conv1``, ``bn1``, ``conv2``, ``bn2``)."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.conv1 = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.bn1 = _bn(mid_channels)
        self.conv2 = nn.Conv2d(mid_channels, out_channels, 3, padding=1)
        self.bn2 = _bn(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_norm_act(x, self.conv1, self.bn1, self.dtype, self.use_kernels)
        return conv_norm_act(x, self.conv2, self.bn2, self.dtype, self.use_kernels)


class ZooDoubleConv(nn.Module):
    """``DoubleConvMid`` as the original zoo's ``common_layers.DoubleConv``
    names it (``double_conv.{0,1,3,4}``): conv3x3 -> BN -> ReLU to
    ``mid_channels``, then to ``out_channels``, both convs int8-gated."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.double_conv = _double_conv(in_channels, out_channels, mid_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return double_conv_norm_act(x, self.double_conv, self.dtype, self.use_kernels)


class Down(nn.Module):
    """2x2 max pool -> :class:`ZooDoubleConv` (JAX ``Down``; the original
    zoo's ``maxpool_conv.1``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2),
            ZooDoubleConv(in_channels, out_channels, out_channels, dtype, use_kernels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv[1](max_pool2d(x, 2))


class UpBilinear(nn.Module):
    """Bilinear 2x resize (``align_corners=True``) -> pad to the skip ->
    concat[skip, x] -> :class:`ZooDoubleConv` to ``mid_channels`` (the
    original zoo's ``in // 2``), then ``out_channels`` (JAX ``UpBilinear``,
    ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.conv = ZooDoubleConv(in_channels, mid_channels, out_channels, dtype, use_kernels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x, (2 * x.shape[-2], 2 * x.shape[-1]), align_corners=True)
        x = pad_to_match(x, (skip.shape[-2], skip.shape[-1]))
        return self.conv(torch.cat([skip, x], dim=1))


class UpConvBlock(nn.Module):
    """Nearest 2x upsample -> conv3x3 -> BN -> ReLU, the conv int8-gated (JAX
    ``UpConvBlock``; the original zoo's ``up.{1,2}``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.up = nn.Sequential(nn.Upsample(scale_factor=2),
                                nn.Conv2d(in_channels, out_channels, 3, padding=1),
                                _bn(out_channels), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_norm_act(upsample2x_nearest(x), self.up[1], self.up[2], self.dtype,
                             self.use_kernels)


class ResidualConv(nn.Module):
    """ResUnet's pre-activation residual block (JAX ``ResidualConv``): BN ->
    ReLU -> conv3x3(stride) -> BN -> ReLU -> conv3x3, plus a 1x1
    conv (stride) and BN on the skip. The three convs have no bias and are
    int8-gated; the original zoo's names ``conv_block.{0,2,3,5}`` and
    ``conv_skip.{0,1}``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.conv_block = nn.Sequential(
            _bn(in_channels), nn.ReLU(inplace=True),
            nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1, bias=False),
            _bn(out_channels), nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False))
        self.conv_skip = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 1, stride=stride, bias=False),
            _bn(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blk, dt, use = self.conv_block, self.dtype, self.use_kernels
        h = gated_conv(torch.relu(batch_norm(x, blk[0])), blk[2], dt, use)
        h = gated_conv(torch.relu(batch_norm(h, blk[3])), blk[5], dt, use)
        skip = batch_norm(gated_conv(x, self.conv_skip[0], dt, use), self.conv_skip[1])
        return h + skip


class DownSample(nn.Module):
    """UNet encoder stage: DoubleConv then 2x2 max pool; returns (skip, pooled)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, dtype, use_kernels)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        down = self.conv(x)
        return down, max_pool2d(down, 2)


class TransposedUp(nn.ConvTranspose2d):
    """ConvTranspose2d(k=2, s=2) computing in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size=2, stride=2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=2)


class KernelWeights(NamedTuple):
    """Folded and packed weights of one decoder stage's kernel path."""

    wt: torch.Tensor   # [Cin, 4*Cu], compute dtype
    bt: torch.Tensor   # [Cu], float32
    wc: torch.Tensor   # [9*(Cu+Cs), Co], compute dtype
    sc1: torch.Tensor  # [Co], float32
    bi1: torch.Tensor
    w2: torch.Tensor   # [Co, Co, 3, 3], conv2 with its BN scale folded in
    b2: torch.Tensor   # [Co], conv2's folded bias; both compute dtype
    packed: Tuple[torch.Tensor, torch.Tensor]  # wt, wc K-major, as the kernel reads them


class UpSampleUNet(nn.Module):
    """ConvTranspose(2,2) -> pad to skip -> concat[x, skip] -> DoubleConv.

    In eval, with the kernel on and ``skip`` exactly twice ``x`` in H and
    W, the stage runs K1 (``fused_up_concat_conv``: ConvT, bias, concat,
    conv1, BN, ReLU) and then conv2 as ``F.conv2d`` with its BN folded,
    then ReLU. Other shapes take the module path, whose ``pad_to_match``
    handles them; the kernel has no padding step.

    ``use_kernels``: ``None`` runs the kernel in eval for bfloat16 CUDA
    activations (the kernel's type); ``True`` runs it in eval whatever the
    device (on the CPU that is its plain version); ``False`` never.

    The JAX package applies conv2's folded BN as a float32 scale and bias
    after the conv; here the scale goes into conv2's weights and the bias
    into its bias, so conv2 and its BN are one cuDNN call and the ReLU one
    in-place pass (the float32 epilogue cost four passes over the stage's
    largest tensor).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.up = TransposedUp(in_channels, in_channels // 2, dtype)
        self.conv = DoubleConv(in_channels, out_channels, dtype, use_kernels)
        self._frozen: Optional[KernelWeights] = None

    def kernel_path(self, x: torch.Tensor, skip: torch.Tensor) -> bool:
        doubled = skip.shape[-2] == 2 * x.shape[-2] and skip.shape[-1] == 2 * x.shape[-1]
        return use_kernel(self.use_kernels, self.training, x, doubled)

    @torch.no_grad()
    def kernel_weights(self) -> KernelWeights:
        """Fold both convs' bias and BN and pack the kernel's weights."""
        dt, op = self.dtype, self.conv.conv_op

        def folded(conv, bn):
            return fold_conv_bn(conv.bias, bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps)

        sc1, bi1 = folded(op[0], op[1])
        sc2, bi2 = folded(op[3], op[4])
        wt = pack_convt_kernel(self.up.weight.to(dt)).contiguous()
        wc = pack_conv3x3_kernel(op[0].weight.to(dt)).contiguous()
        return KernelWeights(
            wt=wt, bt=self.up.bias.float().contiguous(), wc=wc,
            sc1=sc1.contiguous(), bi1=bi1.contiguous(),
            w2=(op[3].weight.float() * sc2.view(-1, 1, 1, 1)).to(dt), b2=bi2.to(dt),
            packed=pack_kernel_weights(wt, wc))

    def freeze_kernel_weights(self) -> None:
        """Fold and pack once for a predictor whose weights no longer change."""
        self._frozen = self.kernel_weights()

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.kernel_path(x, skip):
            return self._fused(x, skip)
        x = self.up(x)
        x = pad_to_match(x, (skip.shape[-2], skip.shape[-1]))
        return self.conv(torch.cat([x, skip], dim=1))

    def _fused(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        w = self._frozen if self._frozen is not None else self.kernel_weights()
        out = fused_up_concat_conv(x, skip, w.wt, w.bt, w.wc, w.sc1, w.bi1, w.packed)
        return torch.relu_(F.conv2d(out, w.w2, w.b2, padding=1))


class OutConv(nn.Module):
    """1x1 output head. Heads to <= 2 channels compute in float32, as the
    JAX package's multiply-and-reduce head does."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv.out_channels <= 2:
            return F.conv2d(x.float(), self.conv.weight.float(),
                            self.conv.bias.float()).to(x.dtype)
        return conv(x, self.conv, self.dtype)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fan-in-scaled normal weights and zero biases, drawn in module order
    from ``generator``; BatchNorm at identity (the defaults).

    Convolutions and transposed convolutions get He scaling (std
    sqrt(2 / fan_in)): every one in ``unet`` feeds a ReLU, so activations
    stay O(1) through the full depth. ``nn.Linear`` and ``nn.Conv1d`` are
    the pointwise MLPs and attention projections inside mmunet's 22
    residual blocks, where eval BatchNorm at identity normalises nothing;
    they get std 0.5 / sqrt(fan_in), a quarter of the LeCun variance, so
    each branch adds a few percent to its input's variance and random
    full-width mmunet logits stay O(1) (``chip_smoke.py`` prints their std).
    A module's ``init_gain`` attribute overrides the gain (MedT's qkv
    projections draw at std sqrt(1 / fan_in), as in JAX), and a module with
    a ``draw_parameters(generator)`` method draws its own other parameters
    (MedT's relative embeddings, swin_unet_v2's ``absolute_pos_embed``)
    when it is reached. Everything else keeps its construction value:
    LayerNorm at identity, SwinV2's ``tau`` at ones, as in JAX.
    """
    for m in module.modules():
        if hasattr(m, "draw_parameters"):
            m.draw_parameters(generator)
        if isinstance(m, nn.ConvTranspose2d):
            # each output sees Cin (k / s)^2 inputs on average (Cin where k == s)
            kh, kw = m.kernel_size
            sh, sw = m.stride
            fan_in, gain = m.in_channels * (kh / sh) * (kw / sw), 2.0
        elif isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            gain = 2.0
        elif isinstance(m, nn.Conv1d):
            fan_in, gain = m.in_channels // m.groups * m.kernel_size[0], 0.25
        elif isinstance(m, nn.Linear):
            fan_in, gain = m.in_features, 0.25
        else:
            continue
        gain = getattr(m, "init_gain", gain)
        m.weight.normal_(0.0, (gain / fan_in) ** 0.5, generator=generator)
        if m.bias is not None:
            m.bias.zero_()
