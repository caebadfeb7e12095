"""Shared transformer primitives (channels-last features [B, H, W, C]).
Counterpart of ``unet_zoo_tpu/nn/transformer.py``: stochastic depth and
dropout (``swin_unet_v2``, UNext), overlap patch embedding,
spatial-reduction attention, the depthwise-conv MLP and the MiT block
(UNext; with the Switch-MoE FFN of ``nn/moe.py`` in ``unext_moe``).

Random draws come from an explicit ``torch.Generator`` (``None``: PyTorch's
default one), drawn on the generator's device and moved to the input's.
JAX's ``jax.random`` gives other numbers from the same seed, so tests feed
both sides the same draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn.blocks import conv
from unet_zoo_tpu_torch.nn.moe import SwitchMoEMLP
from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
from unet_zoo_tpu_torch.ops.kernels import use_kernel


def _uniform(shape, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    device = x.device if generator is None else generator.device
    return torch.rand(shape, generator=generator, device=device).to(x.device)


def _drop_path_uniform(shape, x: torch.Tensor, generator: Optional[torch.Generator]
                       ) -> torch.Tensor:
    """DropPath's uniform in ``x``'s dtype, on the grid JAX draws it on:
    float32 as ``torch.rand``; bfloat16 as ``jax.random.uniform`` does, k / 128
    with k uniform in 0..127 (seven random mantissa bits)."""
    if x.dtype != torch.bfloat16:
        return _uniform(shape, x, generator).to(x.dtype)
    device = x.device if generator is None else generator.device
    k = torch.randint(0, 128, shape, generator=generator, device=device)
    return (k.to(x.device).float() / 128.0).to(torch.bfloat16)


def drop_path_apply(x: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """``x / keep * floor(keep + u)`` as JAX evaluates it in ``x``'s dtype
    (``unet_zoo_tpu/nn/transformer.py:32-33``): the Python float ``keep`` is
    weakly typed there, so it is first rounded to ``x``'s dtype, and the sum
    and the quotient are rounded in that dtype."""
    keep = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return x / keep * torch.floor(keep + u.to(x.dtype))


class DropPath(nn.Module):
    """Per-sample stochastic depth: in training each sample of the batch is
    kept where ``floor(keep + u)`` is 1 and scaled by ``1 / keep``, keep =
    ``1 - rate``; the identity in eval or at rate 0, where nothing is drawn.
    u is drawn in ``x``'s dtype as JAX draws it, so in bfloat16 the kept
    share is JAX's, off the nominal rate (0.8984 at rate 0.1)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        u = _drop_path_uniform((x.shape[0],) + (1,) * (x.dim() - 1), x, generator)
        return drop_path_apply(x, self.rate, u)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None,
            mask_shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Element dropout as Flax's ``nn.Dropout``: keep where u < 1 - rate and
    scale by ``1 / (1 - rate)``; the identity in eval or at rate 0. The
    uniforms u are drawn at ``mask_shape`` (default ``x``'s) and broadcast
    over ``x``: ``(B, C, 1, 1)`` drops whole channels, as Flax's
    ``broadcast_dims=(1, 2)`` on NHWC."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    u = _uniform(x.shape if mask_shape is None else mask_shape, x, generator)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def linear(x: torch.Tensor, m: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``m`` applied in ``dtype`` (Flax's Dense with ``dtype=...``)."""
    return F.linear(x, m.weight.to(dtype), None if m.bias is None else m.bias.to(dtype))


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """``m`` over the last axis in ``x``'s dtype (float32 statistics inside)."""
    return F.layer_norm(x, m.normalized_shape, m.weight.to(x.dtype), m.bias.to(x.dtype), m.eps)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] as an NCHW view (channels_last memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW as [B, H, W, C], contiguous (a view of a channels_last tensor)."""
    return x.permute(0, 2, 3, 1).contiguous()


class OverlapPatchEmbed(nn.Module):
    """Strided conv patch embedding (padding ``patch_size // 2``), then
    LayerNorm (eps 1e-5). [B, H, W, Cin] -> [B, H / stride, W / stride, C]."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int = 7, stride: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride, patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(_nhwc(conv(_nchw(x), self.proj, self.dtype)), self.norm)


class SRAttention(nn.Module):
    """Multi-head self-attention whose keys and values come from a
    ``sr_ratio`` x ``sr_ratio`` stride-``sr_ratio`` conv + LayerNorm of the
    input when ``sr_ratio`` > 1. x: [B, H, W, C] -> [B, H, W, C]. Logits,
    softmax and products in the compute type, as the JAX module (XLA) runs
    them; ATen and cuBLAS here."""

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 1, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.sr_ratio, self.dtype = num_heads, sr_ratio, dtype
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        b, h, w, c = x.shape
        nh, dt = self.num_heads, self.dtype
        q = linear(x, self.q, dt).reshape(b, h * w, nh, c // nh)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = layer_norm(_nhwc(conv(_nchw(x), self.sr, dt)), self.norm)
        n_kv = kv_in.shape[1] * kv_in.shape[2]
        kv = linear(kv_in, self.kv, dt).reshape(b, n_kv, 2, nh, c // nh)
        k, v = kv[:, :, 0], kv[:, :, 1]
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
        attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop, self.training, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, h, w, c)
        return dropout(linear(out, self.proj, dt), self.proj_drop, self.training, generator)


class DWConv(nn.Module):
    """3x3 depthwise conv (with bias) over [B, H, W, C] features.

    Module path: ``nn.Conv2d(groups=C)`` in the compute type, the counterpart
    of JAX's grouped ``nn.Conv``. Kernel path (the shared rule of
    ``ops.kernels.use_kernel``: ``None`` in eval for bfloat16 CUDA
    activations, ``True`` in eval anywhere, which on the CPU means the plain
    version, ``False`` never, never in training: the JAX package has no
    backward for it): K3, ``depthwise_conv2d``, with the conv's weight as a
    [3, 3, C] kernel and its bias, both cast to the compute type as JAX's
    ``DWConv`` casts them. The ``state_dict`` keys are the same on both paths.
    """

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.use_kernels = dtype, use_kernels
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self._frozen: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def kernel_path(self, x: torch.Tensor) -> bool:
        return use_kernel(self.use_kernels, self.training, x)

    @torch.no_grad()
    def kernel_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """K3's [3, 3, C] kernel and [C] bias in the compute type."""
        w = self.dwconv.weight
        return (w[:, 0].permute(1, 2, 0).to(self.dtype).contiguous(),
                self.dwconv.bias.to(self.dtype).contiguous())

    def freeze_kernel_weights(self) -> None:
        """Lay out the kernel once for a predictor whose weights no longer change."""
        self._frozen = self.kernel_weights()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_path(x):
            kern, bias = self._frozen if self._frozen is not None else self.kernel_weights()
            return k3.depthwise_conv2d(x, kern, bias)
        return _nhwc(conv(_nchw(x), self.dwconv, self.dtype))


class DWConvMLP(nn.Module):
    """fc1 -> DWConv -> exact GELU -> fc2, the GELU applied to the depthwise
    conv's output (the original zoo's order)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: Optional[int] = None,
                 drop: float = 0.0, dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.drop = dtype, drop
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.dwconv = DWConv(hidden_dim, dtype, use_kernels)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h = F.gelu(self.dwconv(linear(x, self.fc1, self.dtype)))
        h = dropout(h, self.drop, self.training, generator)
        h = linear(h, self.fc2, self.dtype)
        return dropout(h, self.drop, self.training, generator)


class MiTBlock(nn.Module):
    """Pre-norm transformer block: x + attn(LN(x)), then x + mlp(LN(x)),
    each branch through DropPath. x: [B, H, W, C]. With ``moe_experts`` > 0
    the FFN is ``moe_mlp``, a Switch-MoE of that many experts of the same
    hidden width (no depthwise conv), in place of ``mlp``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, sr_ratio: int = 1,
                 qkv_bias: bool = False, qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0, moe_experts: int = 0,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, qk_scale, attn_drop, drop,
                                dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        if moe_experts > 0:
            self.moe_mlp = SwitchMoEMLP(dim, moe_experts, int(dim * mlp_ratio), dtype=dtype)
        else:
            self.mlp = DWConvMLP(dim, int(dim * mlp_ratio), drop=drop, dtype=dtype,
                                 use_kernels=use_kernels)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.drop_path(self.attn(layer_norm(x, self.norm1), generator), generator)
        h = layer_norm(x, self.norm2)
        h = self.moe_mlp(h) if hasattr(self, "moe_mlp") else self.mlp(h, generator)
        return x + self.drop_path(h, generator)
