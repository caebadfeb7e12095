"""Swin-UNet V2 (``swin_unet_v2``). Counterpart of
``unet_zoo_tpu/models/swin_unet_v2.py``.

SwinV2 as the JAX package builds it: cosine attention on a pre-scaled q,
divided per element by ``tau`` clipped at 0.01, plus a continuous
relative position bias from a 2 -> 256 -> heads ReLU MLP (``cpb``) on
``sign(d) log1p(|d|)`` coordinates; res-post-norm blocks; shifted windows
with a 0 / -100 mask built from the static resolution. The blocks are
attention-only (``use_mlp=False``), the original zoo's quirk; ``use_mlp``
restores the MLP. Images come in NCHW and logits go out NCHW; inside, tokens
are [B, L, C] as in JAX.

Module and attribute names follow the original PyTorch zoo
(``patch_embed.{proj,norm}``, ``layers.{l}.blocks.{i}.attn.{qkv,proj,cpb.fc1,
cpb.fc2,tau}``, ``layers.{l}.downsample``, ``layers_up.0``,
``layers_up.{u}.{blocks,upsample}``, ``concat_back_dim.{u}``, ``norm``,
``norm_up``, ``up``, ``output``), so ``state_dict`` keys match what
``unet_zoo_tpu.utils.convert`` reads. Parameters are stored in float32 and
cast to the compute ``dtype`` at use.

Kernel (``use_kernels``, the shared rule of ``ops.kernels.use_kernel``:
``None`` runs it in eval for bfloat16 CUDA activations; ``True`` in eval on
any device, which on the CPU means its plain version; ``False`` never; in
training never, the JAX package has no backward for it): every
``WindowAttentionV2`` runs K2, ``swin_window_attention``, from the scaled q,
k and v to the attention output. Its tables are float32: ``clip(tau,
0.01)`` and the CPB table computed in float32 from the (possibly
bf16-rounded) parameters, once by ``freeze_kernel_weights``. The module path
computes the CPB MLP in the compute type every forward, as JAX does. K2
takes bfloat16 or float32 activations; there is no shape gate, the wrapper
raises for a window or head it does not take.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import conv
from unet_zoo_tpu_torch.nn.transformer import DropPath, dropout, layer_norm, linear
from unet_zoo_tpu_torch.ops.kernels import use_kernel
from unet_zoo_tpu_torch.ops.kernels import window_attention as k2


@functools.lru_cache(maxsize=None)
def _log_relative_coords(n_h: int, n_w: int) -> np.ndarray:
    """sign(d) * log(1 + |d|) relative coordinates, [N, N, 2]."""
    coords = np.stack(np.meshgrid(np.arange(n_h), np.arange(n_w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.float32)
    return np.sign(rel) * np.log1p(np.abs(rel))


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(0 / -100) mask [nW, N, N] of shifted windows, windows in row-major
    order over the (rolled) image."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws_] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, window*window, C], windows ordered (image, row
    of windows, column of windows)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, window*window, C] -> [B, H, W, C]."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class _CPB(nn.Module):
    """The continuous position bias MLP's two layers (``cpb.fc1``, ``cpb.fc2``)."""

    def __init__(self, heads: int):
        super().__init__()
        self.fc1 = nn.Linear(2, 256)
        self.fc2 = nn.Linear(256, heads)


class WindowAttentionV2(nn.Module):
    """Cosine window attention with tau and the log-CPB bias. x: [B*nW, N,
    C] windows -> [B*nW, N, C]; ``mask`` [nW, N, N] or None."""

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.num_heads, self.dtype, self.use_kernels = num_heads, dtype, use_kernels
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        n = window_size[0] * window_size[1]
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.cpb = _CPB(num_heads)
        self.tau = nn.Parameter(torch.ones(num_heads, n, n))
        self.register_buffer("coords", torch.from_numpy(_log_relative_coords(*window_size)),
                             persistent=False)
        self._frozen: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def kernel_path(self, x: torch.Tensor) -> bool:
        return use_kernel(self.use_kernels, self.training, x)

    def cpb_bias(self, dtype: torch.dtype) -> torch.Tensor:
        """The CPB MLP on the window's coordinates in ``dtype``: [nh, N, N]."""
        h = torch.relu(linear(self.coords.to(dtype), self.cpb.fc1, dtype))
        return linear(h, self.cpb.fc2, dtype).permute(2, 0, 1)

    @torch.no_grad()
    def kernel_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """K2's float32 tables: ``clip(tau, 0.01)`` and the CPB table."""
        return (k2._clip_tau(self.tau).contiguous(),
                self.cpb_bias(torch.float32).contiguous())

    def freeze_kernel_weights(self) -> None:
        """Build the tables once for a predictor whose weights no longer change."""
        self._frozen = self.kernel_tables()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b_, n, c = x.shape
        qkv = linear(x, self.qkv, self.dtype).reshape(b_, n, 3, self.num_heads, -1)
        q, k, v = qkv.unbind(2)                                   # [B_, N, nh, hd]
        if self.kernel_path(x):
            tau, bias = self._frozen if self._frozen is not None else self.kernel_tables()
            out = k2.swin_window_attention((q * self.scale).transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), tau, bias, mask)
            out = out.transpose(1, 2).reshape(b_, n, c)
        else:
            out = self.attend(q, k, v, mask, generator)
        out = linear(out, self.proj, self.dtype)
        return dropout(out, self.proj_drop, self.training, generator)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The module path from q, k, v [B_, N, nh, hd] to the attention
        output [B_, N, C], what K2 replaces: float32 logits and softmax,
        P rounded to the compute type for P·V, as the JAX module does."""
        b_, n, nh, hd = q.shape
        q = (q * self.scale).float()
        k32 = k.float()
        dots = torch.einsum("bqhd,bkhd->bhqk", q, k32)
        qn = torch.linalg.vector_norm(q, dim=-1).transpose(1, 2)    # [B_, nh, N]
        kn = torch.linalg.vector_norm(k32, dim=-1).transpose(1, 2)
        attn = dots / torch.clamp_min(qn[:, :, :, None] * kn[:, :, None, :], 1e-6)
        attn = attn / k2._clip_tau(self.tau[None, :, :n, :n])
        attn = attn + self.cpb_bias(self.dtype).float()[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]).reshape(
                b_, nh, n, n)
        attn = dropout(torch.softmax(attn, dim=-1), self.attn_drop, self.training, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype), v)
        return out.reshape(b_, n, nh * hd)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlockV2(nn.Module):
    """Shifted-window block with res-post-norm: x + norm1(attention). A
    resolution no larger than the window shrinks the window to it and
    drops the shift. x: [B, H*W, C]."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], num_heads: int,
                 window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0, use_mlp: bool = False,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        h, w = input_resolution
        if min(h, w) <= window_size:
            window_size, shift_size = min(h, w), 0
        self.input_resolution, self.window, self.shift = (h, w), window_size, shift_size
        self.dtype, self.drop = dtype, drop
        self.attn = WindowAttentionV2(dim, (window_size, window_size), num_heads, qkv_bias,
                                      qk_scale, attn_drop, drop, dtype, use_kernels)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.drop_path = DropPath(drop_path)
        self.use_mlp = use_mlp
        if use_mlp:
            self.mlp = _Mlp(dim, int(dim * mlp_ratio))
            self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        mask = (torch.from_numpy(_shift_attn_mask(h, w, window_size, shift_size))
                if shift_size > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        h, w = self.input_resolution
        b, l, c = x.shape
        window, shift = self.window, self.shift
        xs = x.reshape(b, h, w, c)
        if shift > 0:
            xs = torch.roll(xs, (-shift, -shift), dims=(1, 2))
        attn_out = self.attn(window_partition(xs, window), self.attn_mask, generator)
        xs = window_reverse(attn_out, window, h, w)
        if shift > 0:
            xs = torch.roll(xs, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(layer_norm(xs.reshape(b, l, c), self.norm1), generator)
        if self.use_mlp:
            dt, training = self.dtype, self.training
            m = F.gelu(linear(x, self.mlp.fc1, dt))
            m = dropout(m, self.drop, training, generator)
            m = dropout(linear(m, self.mlp.fc2, dt), self.drop, training, generator)
            x = x + self.drop_path(layer_norm(m, self.norm2), generator)
        return x


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated in the order [0::2, 0::2], [1::2, 0::2],
    [0::2, 1::2], [1::2, 1::2] -> LayerNorm(4C) -> Linear(4C -> 2C)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, _, c = x.shape
        xs = x.reshape(b, h, w, c)
        xs = torch.cat([xs[:, 0::2, 0::2], xs[:, 1::2, 0::2], xs[:, 0::2, 1::2],
                        xs[:, 1::2, 1::2]], dim=-1).reshape(b, -1, 4 * c)
        return linear(layer_norm(xs, self.norm), self.reduction, self.dtype)


def _depth_to_space(x: torch.Tensor, h: int, w: int, p: int) -> torch.Tensor:
    """[B, H*W, p*p*C] -> [B, H*p*W*p, C]: reshape (b, h, w, p, p, C), then
    the axes (0, 1, 3, 2, 4, 5)."""
    b = x.shape[0]
    c = x.shape[-1] // (p * p)
    x = x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * p * w * p, c)


class PatchExpand(nn.Module):
    """Linear(C -> 2C) -> depth-to-space 2 -> LayerNorm(C/2)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _depth_to_space(linear(x, self.expand, self.dtype), *self.input_resolution, 2)
        return layer_norm(x, self.norm)


class FinalPatchExpandX4(nn.Module):
    """Linear(C -> 16C) -> depth-to-space 4 -> LayerNorm(C).

    ``defer_rearrange=True`` returns [B, L, 16, C] with the LayerNorm applied
    per final pixel and the 4x4 depth-to-space left to the caller: the same
    values, reordered (each pixel's C-vector is one slice of the expansion)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_resolution, self.dtype = input_resolution, dtype
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, defer_rearrange: bool = False) -> torch.Tensor:
        b, l, c = x.shape
        x = linear(x, self.expand, self.dtype)
        if defer_rearrange:
            return layer_norm(x.reshape(b, l, 16, c), self.norm)
        return layer_norm(_depth_to_space(x, *self.input_resolution, 4), self.norm)


class BasicLayer(nn.Module):
    """A stage's blocks, then its ``downsample`` (encoder) or ``upsample``
    (decoder) when it has one."""

    def __init__(self, blocks, downsample: Optional[nn.Module] = None,
                 upsample: Optional[nn.Module] = None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample
        if upsample is not None:
            self.upsample = upsample

    def run_blocks(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, generator)
        return x


class _PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, patch_size: int, patch_norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        if patch_norm:
            self.norm = nn.LayerNorm(embed_dim, eps=1e-5)


class SwinUNetV2(nn.Module):
    """SwinTransformerSys: patch embedding, an encoder of SwinV2 stages with
    patch merging, a decoder of patch expansions with skip concatenation
    (``concat_back_dim``), and the x4 expansion + 1x1 head. Images must be
    ``img_size`` square. Returns ``{'main': logits [B, classes, H, W]}``."""

    def __init__(self, img_size: int = 224, patch_size: int = 4, in_chans: int = 3,
                 num_classes: int = 1000, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1, ape: bool = False,
                 patch_norm: bool = True, use_mlp: bool = False,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.img_size, self.patch_size = dtype, img_size, patch_size
        self.embed_dim, self.drop_rate = embed_dim, drop_rate
        nl = len(depths)
        pr = img_size // patch_size
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        self.patch_embed = _PatchEmbed(in_chans, embed_dim, patch_size, patch_norm)
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, pr * pr, embed_dim))

        def blocks(dim, res, depth, heads, dp):
            return [SwinBlockV2(dim, (res, res), heads, window_size,
                                0 if i % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                                qk_scale, drop_rate, attn_drop_rate, dp[i], use_mlp, dtype,
                                use_kernels) for i in range(depth)]

        self.layers = nn.ModuleList()
        for li in range(nl):
            dim, res = embed_dim * 2 ** li, pr // 2 ** li
            start = sum(depths[:li])
            self.layers.append(BasicLayer(
                blocks(dim, res, depths[li], num_heads[li], dpr[start:start + depths[li]]),
                downsample=PatchMerging((res, res), dim, dtype) if li < nl - 1 else None))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (nl - 1), eps=1e-5)

        self.layers_up = nn.ModuleList()
        self.concat_back_dim = nn.ModuleList()
        for ui in range(nl):
            li = nl - 1 - ui
            dim, res = embed_dim * 2 ** li, pr // 2 ** li
            if ui == 0:
                self.layers_up.append(PatchExpand((res, res), dim, dtype))
                self.concat_back_dim.append(nn.Identity())
                continue
            start = sum(depths[:li])
            self.layers_up.append(BasicLayer(
                blocks(dim, res, depths[li], num_heads[li], dpr[start:start + depths[li]]),
                upsample=PatchExpand((res, res), dim, dtype) if ui < nl - 1 else None))
            self.concat_back_dim.append(nn.Linear(2 * dim, dim))
        self.norm_up = nn.LayerNorm(embed_dim, eps=1e-5)
        self.up = FinalPatchExpandX4((pr, pr), embed_dim, dtype)
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        """``absolute_pos_embed`` (``ape``) at std 0.02, truncated at 2 std."""
        if hasattr(self, "absolute_pos_embed"):
            self.absolute_pos_embed.normal_(0.0, 0.02, generator=generator).clamp_(-0.04, 0.04)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """x: [B, C, img_size, img_size]; ``generator`` feeds dropout and
        stochastic depth in training."""
        dt, p, e = self.dtype, self.patch_size, self.embed_dim
        pr = self.img_size // p
        if tuple(x.shape[-2:]) != (self.img_size, self.img_size):
            raise ValueError(f"swin_unet_v2 was built for {self.img_size}px images, "
                             f"got {tuple(x.shape[-2:])}")
        h = conv(x.to(dtype=dt, memory_format=torch.channels_last), self.patch_embed.proj, dt)
        b = h.shape[0]
        h = h.permute(0, 2, 3, 1).reshape(b, pr * pr, e)
        if hasattr(self.patch_embed, "norm"):
            h = layer_norm(h, self.patch_embed.norm)
        if hasattr(self, "absolute_pos_embed"):
            h = h + self.absolute_pos_embed.to(dt)
        h = dropout(h, self.drop_rate, self.training, generator)

        skips = []
        for layer in self.layers:
            skips.append(h)
            h = layer.run_blocks(h, generator)
            if hasattr(layer, "downsample"):
                h = layer.downsample(h)
        h = layer_norm(h, self.norm)
        for ui, layer in enumerate(self.layers_up):
            if ui == 0:
                h = layer(h)
                continue
            h = torch.cat([h, skips[len(skips) - 1 - ui]], dim=-1)
            h = layer.run_blocks(linear(h, self.concat_back_dim[ui], dt), generator)
            if hasattr(layer, "upsample"):
                h = layer.upsample(h)
        h = layer_norm(h, self.norm_up)

        # The 1x1 head acts per final pixel: in eval it runs before the 4x4
        # depth-to-space (the JAX package's head-commute), so only the
        # class channels are rearranged; training keeps the plain order.
        w_out = self.output.weight[:, :, 0, 0].to(dt)
        k = w_out.shape[0]
        if not self.training:
            out = F.linear(self.up(h, defer_rearrange=True), w_out)       # [B, L, 16, K]
            out = out.reshape(b, pr, pr, 4, 4, k).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(b, 4 * pr, 4 * pr, k)
        else:
            out = F.linear(self.up(h).reshape(b, 4 * pr, 4 * pr, e), w_out)
        return {"main": out.permute(0, 3, 1, 2)}
