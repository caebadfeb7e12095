"""MedT axial-attention family: ``axialunet`` (``base``), ``gated`` and
``logo`` (``gated``), ``medt`` (``wopos``) and the LoGo dual-branch
``medt_logo``. Counterpart of ``unet_zoo_tpu/models/medt_net.py``.

Axial attention runs 1-D attention along an image axis, with relative
position embeddings in three similarity terms (qk, qr, kr) that share one
BatchNorm over the 3g similarity channels, and two output terms (sv, sve)
BatchNorm'd as interleaved pairs. ``gated`` scales qr, kr, sv and sve by
learnable scalar gates; ``wopos`` drops the position terms.

Module and attribute names follow the original PyTorch zoo (``conv1..3``,
``layer{l}.{b}.hight_block.qkv_transform.conv``, ``downsample.{0,1}``,
``decoder1..4``, ``final_conv``; LoGo's ``*_p``, ``decoderf``, ``adjust``),
so ``state_dict`` keys match what ``unet_zoo_tpu.utils.convert`` reads.

Kernels (``use_kernels``, the shared rule of ``ops.kernels.use_kernel``:
``None`` runs them for bfloat16 CUDA activations; ``True`` on any device,
which on the CPU means their plain versions; ``False`` never):

- in eval every axis pass runs K6, ``fused_axial_attention``, on the output
  of the qkv projection with ``bn_qkv`` folded into it; the BatchNorms and
  gates after it fold into the kernel's scales. ``None`` includes
  ``wopos``, which the JAX package's TPU gate leaves off: on the H100 the
  kernel path serves ``medt`` about twice as fast as the module path
  (PERF.md);
- in training the positional modes (``base``, ``gated``) run K7,
  ``fused_axial_train``, from the batch-normalised projections to sv and
  sve (the counterpart of ``_fused_train_path``,
  ``unet_zoo_tpu/models/medt_net.py:285-330``); the qkv projection,
  ``bn_qkv``, the gates and ``bn_output`` stay in PyTorch, and
  ``bn_similarity``'s running statistics take K7's biased moments. K7
  takes bfloat16 activations on the card: a float32 model with
  ``use_kernels=True`` raises in training (in eval K6 takes a bf16 copy).
  ``wopos`` trains on the module path: the JAX package has no train kernel
  for it.

The module path applies every BatchNorm as the JAX package's module path
does, in eval and in training. There is no shape gate: on the card K6
takes group widths gp in ``k6.GROUP_PLANES`` and axes up to
``k6.MAX_LENGTH`` that fit its shared memory, K7 gp in ``k7.GROUP_PLANES``
and axes up to ``k7.MAX_LENGTH``; each raises for any other block, rather
than hand it to the module path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu_torch.nn import batch_norm, conv, update_running_stats
from unet_zoo_tpu_torch.ops import avg_pool2d, resize_bilinear
from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6
from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
from unet_zoo_tpu_torch.ops.kernels import use_kernel

MODES = ("base", "gated", "wopos")


def _bn_last(t: torch.Tensor, bn: nn.Module) -> torch.Tensor:
    """``bn`` over the last axis of ``t`` (float32 statistics and affine)."""
    return batch_norm(t.reshape(-1, t.shape[-1]), bn).reshape(t.shape)


def _unrows(t: torch.Tensor, batch: int, width_axis: bool) -> torch.Tensor:
    """[B*R, L, C] rows of an axis pass -> [B, C, H, W] channels_last."""
    x = t.reshape(batch, -1, t.shape[1], t.shape[2])
    if not width_axis:
        x = x.transpose(1, 2)
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class _QKVConv(nn.Conv1d):
    """The qkv projection's 1x1 ``Conv1d``; drawn at std sqrt(1 / C_in), the
    JAX package's initialiser (``init_weights`` reads ``init_gain``)."""

    init_gain = 1.0


class _QKVTransform(nn.Module):
    """Holder of ``conv`` (the original zoo's ``qkv_transform``)."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.conv = _QKVConv(in_planes, out_planes, 1, bias=False)


class AxialAttention(nn.Module):
    """Attention along H (``width_axis=False``) or W, then an average pool
    when ``stride`` > 1. x: [B, in_planes, H, W] -> [B, out_planes, H', W']."""

    def __init__(self, in_planes: int, out_planes: int, groups: int = 8,
                 kernel_size: int = 56, stride: int = 1, width_axis: bool = False,
                 mode: str = "base", dtype: torch.dtype = torch.float32,
                 use_kernels: Optional[bool] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.out_planes, self.groups, self.group_planes = out_planes, groups, out_planes // groups
        self.kernel_size, self.stride, self.width_axis = kernel_size, stride, width_axis
        self.mode, self.dtype, self.use_kernels = mode, dtype, use_kernels
        wopos = mode == "wopos"
        self.qkv_transform = _QKVTransform(in_planes, 2 * out_planes)
        self.bn_qkv = nn.BatchNorm1d(2 * out_planes)
        self.bn_similarity = nn.BatchNorm2d(groups if wopos else 3 * groups)
        self.bn_output = nn.BatchNorm1d(out_planes if wopos else 2 * out_planes)
        if not wopos:
            self.relative = nn.Parameter(torch.zeros(2 * self.group_planes, 2 * kernel_size - 1))
        if mode == "gated":
            for name, value in (("f_qr", 0.1), ("f_kr", 0.1), ("f_sv", 1.0), ("f_sve", 0.1)):
                setattr(self, name, nn.Parameter(torch.tensor(value)))
        self._frozen: Optional[k6.AxialWeights] = None

    @torch.no_grad()
    def draw_parameters(self, generator: torch.Generator) -> None:
        """``relative`` at std sqrt(1 / gp), as the JAX package draws it."""
        if self.mode != "wopos":
            self.relative.normal_(0.0, (1.0 / self.group_planes) ** 0.5, generator=generator)

    def kernel_path(self, x: torch.Tensor) -> bool:
        return use_kernel(self.use_kernels, self.training, x, trains=self.mode != "wopos")

    def freeze_kernel_weights(self) -> None:
        """Fold once for a predictor whose weights no longer change."""
        self._frozen = k6.fold_axial_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.kernel_path(x):
            out = self._module(x)
        elif self.training:
            out = self._train_kernel(x)
        else:
            out = self._kernel(x)
        return avg_pool2d(out, self.stride) if self.stride > 1 else out

    def _kernel(self, x: torch.Tensor) -> torch.Tensor:
        w = self._frozen if self._frozen is not None else k6.fold_axial_params(self)
        qkv = F.conv2d(x, w.qkv_weight, w.qkv_bias)
        if qkv.is_cuda:
            qkv = qkv.to(torch.bfloat16)
        qkv = qkv.contiguous(memory_format=torch.channels_last)
        out = k6.fused_axial_attention(qkv, w.relative, w.sim_scale, w.out_scale, w.out_shift,
                                       self.kernel_size, self.width_axis)
        return out.to(self.dtype)

    def _projections(self, x: torch.Tensor) -> torch.Tensor:
        """The qkv projections of the axis pass's rows: [B*R, L, 2*out]."""
        tokens = k6.axis_rows(x, self.width_axis)                   # [B*R, L, C_in]
        return tokens @ self.qkv_transform.conv.weight[:, :, 0].t().to(self.dtype)

    def _module(self, x: torch.Tensor) -> torch.Tensor:
        return _unrows(self.core(self._projections(x)), x.shape[0], self.width_axis)

    def _train_kernel(self, x: torch.Tensor) -> torch.Tensor:
        return _unrows(self.train_core(self._projections(x)), x.shape[0], self.width_axis)

    def train_core(self, qkv: torch.Tensor) -> torch.Tensor:
        """The train kernel path from ``bn_qkv`` to ``bn_output`` (what the
        module path's :meth:`core` computes in training): K7 between the
        batch-normalised projections and the output BatchNorm. On the card
        K7 takes bfloat16 only: a float32 module raises here rather than
        train below the precision it was built with."""
        dt, g, gp = self.dtype, self.groups, self.group_planes
        n, length, _ = qkv.shape
        c = gp // 2
        qkv = _bn_last(qkv, self.bn_qkv)
        if qkv.is_cuda and qkv.dtype != torch.bfloat16:
            raise ValueError(f"K7 trains bfloat16 activations on the card, not {qkv.dtype}: "
                             "build the model with dtype=torch.bfloat16, or use_kernels=False "
                             "to train it on its module path")
        qkv = qkv.reshape(n, length, g, 2 * gp)
        q, k, v = qkv[..., :c], qkv[..., c:gp], qkv[..., gp:]
        qg, kg = q, k
        if self.mode == "gated":
            qg, kg = q * self.f_qr.to(q.dtype), k * self.f_kr.to(q.dtype)
        bn = self.bn_similarity
        sv, sve, mu, var = k7.fused_axial_train(q, k, qg, kg, v, self.relative,
                                                bn.weight.reshape(3, g), self.kernel_size, bn.eps)
        update_running_stats(bn, mu, var)
        return self._output(sv.to(dt), sve.to(dt))

    def core(self, qkv: torch.Tensor) -> torch.Tensor:
        """The module path from ``bn_qkv`` to ``bn_output``, what K6 replaces
        in eval and K7 in training: qkv projections [N, L, 2*out] -> [N, L, out]."""
        dt, g, gp, out = self.dtype, self.groups, self.group_planes, self.out_planes
        n, length, _ = qkv.shape
        c = gp // 2
        qkv = _bn_last(qkv, self.bn_qkv).reshape(n, length, g, 2 * gp)
        q, k, v = qkv[..., :c], qkv[..., c:gp], qkv[..., gp:]
        if self.mode == "wopos":
            sim = _bn_last(torch.einsum("nigc,njgc->nijg", q, k), self.bn_similarity)
            sim = torch.softmax(sim, dim=2)                             # over keys j
            sv = torch.einsum("nijg,njgc->nigc", sim, v).reshape(n, length, out)
            return _bn_last(sv, self.bn_output)

        emb = k6.relative_embeddings(self.relative.to(dt), self.kernel_size, length)
        q_emb, k_emb, v_emb = emb[:c], emb[c:gp], emb[gp:]
        qr = torch.einsum("nigc,cij->nijg", q, q_emb)
        kr = torch.einsum("njgc,cji->nijg", k, k_emb)
        qk = torch.einsum("nigc,njgc->nijg", q, k)
        if self.mode == "gated":
            qr, kr = qr * self.f_qr.to(dt), kr * self.f_kr.to(dt)
        # BN over the 3g similarity channels (term-major), then sum the terms
        stacked = _bn_last(torch.cat([qk, qr, kr], dim=-1), self.bn_similarity)
        sim = torch.softmax(stacked.reshape(n, length, length, 3, g).sum(3), dim=2)
        sv = torch.einsum("nijg,njgc->nigc", sim, v)
        sve = torch.einsum("nijg,cij->nigc", sim, v_emb)
        return self._output(sv, sve)

    def _output(self, sv: torch.Tensor, sve: torch.Tensor) -> torch.Tensor:
        """Gates, then (sv, sve) interleaved per channel, BN, each pair summed:
        [N, L, g, gp] twice -> [N, L, out]."""
        dt, out = self.dtype, self.out_planes
        n, length, g, gp = sv.shape
        if self.mode == "gated":
            sv, sve = sv * self.f_sv.to(dt), sve * self.f_sve.to(dt)
        paired = _bn_last(torch.stack([sv, sve], dim=-1).reshape(n, length, 2 * out),
                          self.bn_output)
        return paired.reshape(n, length, g, gp, 2).sum(-1).reshape(n, length, out)


class AxialBlock(nn.Module):
    """conv1x1 down -> height attention -> width attention (stride) ->
    conv1x1 up, plus the (projected) residual; ReLU."""

    expansion = 2

    def __init__(self, inplanes: int, planes: int, kernel_size: int, stride: int = 1,
                 groups: int = 8, base_width: int = 64, mode: str = "base",
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        width = int(planes * (base_width / 64.0))
        out_ch = planes * self.expansion
        self.conv_down = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.hight_block = AxialAttention(width, width, groups, kernel_size, mode=mode,
                                          dtype=dtype, use_kernels=use_kernels)
        self.width_block = AxialAttention(width, width, groups, kernel_size, stride,
                                          width_axis=True, mode=mode, dtype=dtype,
                                          use_kernels=use_kernels)
        self.conv_up = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = torch.relu(batch_norm(conv(x, self.conv_down, dt), self.bn1))
        h = torch.relu(self.width_block(self.hight_block(h)))
        h = batch_norm(conv(h, self.conv_up, dt), self.bn2)
        identity = x
        if self.downsample is not None:
            identity = batch_norm(conv(x, self.downsample[0], dt), self.downsample[1])
        return torch.relu(h + identity)


def _axial_stage(inplanes: int, planes: int, blocks: int, stride: int, kernel_size: int,
                 mode: str, groups: int, base_width: int, dtype, use_kernels):
    """``blocks`` AxialBlocks (the zoo's ``_make_layer``); returns the stage
    and its output channels. Blocks after a strided first one attend over
    half the kernel size."""
    layers = []
    for bi in range(blocks):
        ks = kernel_size if bi == 0 else (kernel_size // 2 if stride != 1 else kernel_size)
        layers.append(AxialBlock(inplanes, planes, ks, stride if bi == 0 else 1, groups,
                                 base_width, mode, dtype, use_kernels))
        inplanes = planes * AxialBlock.expansion
    return nn.Sequential(*layers), inplanes


def _up2(z: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(z, (2 * z.shape[-2], 2 * z.shape[-1]), align_corners=True)


def _add_stem(owner: nn.Module, in_channels: int, planes: int, suffix: str = "") -> None:
    """conv7x7/s2 -> BN -> ReLU -> conv3x3 (128) -> BN -> ReLU -> conv3x3 ->
    BN -> ReLU, held as ``conv{1,2,3}{suffix}`` / ``bn{1,2,3}{suffix}`` on
    ``owner`` (the original zoo keeps them flat); run by :func:`_stem`."""
    for i, (cin, cout, k, s) in enumerate(((in_channels, planes, 7, 2), (planes, 128, 3, 1),
                                           (128, planes, 3, 1)), start=1):
        owner.add_module(f"conv{i}{suffix}", nn.Conv2d(cin, cout, k, s, k // 2, bias=False))
        owner.add_module(f"bn{i}{suffix}", nn.BatchNorm2d(cout))


def _stem(owner: nn.Module, x: torch.Tensor, dtype, suffix: str = "") -> torch.Tensor:
    for i in (1, 2, 3):
        x = torch.relu(batch_norm(conv(x, getattr(owner, f"conv{i}{suffix}"), dtype),
                                  getattr(owner, f"bn{i}{suffix}")))
    return x


class ResAxialAttentionUNet(nn.Module):
    """Axial-attention UNet: 3-conv stem (stride-2 first), four axial stages
    scaled by ``s``, a conv + bilinear (align_corners) decoder with additive
    skips. Axis kernel sizes follow ``img_size``; images may be smaller."""

    def __init__(self, mode: str = "base", layers: Sequence[int] = (1, 2, 4, 1),
                 num_classes: int = 1, in_channels: int = 3, img_size: int = 128,
                 s: float = 0.125, groups: int = 8, width_per_group: int = 64,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        inplanes = int(64 * s)
        _add_stem(self, in_channels, inplanes)
        specs = [(int(128 * s), layers[0], 1, img_size // 2),
                 (int(256 * s), layers[1], 2, img_size // 2),
                 (int(512 * s), layers[2], 2, img_size // 4),
                 (int(1024 * s), layers[3], 2, img_size // 8)]
        for li, (planes, blocks, stride, ks) in enumerate(specs, start=1):
            stage, inplanes = _axial_stage(inplanes, planes, blocks, stride, ks, mode, groups,
                                           width_per_group, dtype, use_kernels)
            self.add_module(f"layer{li}", stage)
        e = AxialBlock.expansion
        chans = [int(1024 * s) * e, int(512 * e * s), int(256 * e * s), int(128 * e * s),
                 int(64 * e * s)]
        for d in range(1, 5):
            self.add_module(f"decoder{d}", nn.Conv2d(chans[d - 1], chans[d], 3, padding=1))
        self.final_conv = nn.Conv2d(chans[4], num_classes, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images; returns ``{'main': logits [B, classes, H, W]}``."""
        dt = self.dtype
        h = _stem(self, x.to(dtype=dt, memory_format=torch.channels_last), dt)
        x1 = self.layer1(h)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        u = torch.relu(conv(_up2(x4), self.decoder1, dt) + x3)
        u = torch.relu(conv(_up2(u), self.decoder2, dt) + x2)
        u = torch.relu(conv(_up2(u), self.decoder3, dt) + x1)
        u = torch.relu(conv(_up2(u), self.decoder4, dt))
        return {"main": conv(u, self.final_conv, dt)}


class MedTLoGo(nn.Module):
    """LoGo dual-branch MedT: a global branch (stem, two ``gated`` axial
    stages, two decoder steps) on the whole image, and a local branch
    (stem, four ``wopos`` stages, five decoder steps) on every
    ``patch_size`` patch, with the patches folded into the batch; the two
    are summed and fused.

    The local stem is ``int(256 * s) * 2`` channels wide, not the global
    stem's ``int(64 * s)``: the original zoo builds it after its global
    stages have raised ``self.inplanes``, and the JAX package keeps that.
    """

    def __init__(self, mode: str = "gated", mode_local: str = "wopos",
                 layers: Sequence[int] = (1, 2, 4, 1), num_classes: int = 1,
                 in_channels: int = 3, img_size: int = 128, s: float = 0.125,
                 groups: int = 8, width_per_group: int = 64, patch_size: int = 32,
                 dtype: torch.dtype = torch.float32, use_kernels: Optional[bool] = None):
        super().__init__()
        self.dtype, self.patch_size = dtype, patch_size
        e = AxialBlock.expansion

        def stage(name, inplanes, planes, blocks, stride, ks, m):
            seq, out = _axial_stage(inplanes, planes, blocks, stride, ks, m, groups,
                                    width_per_group, dtype, use_kernels)
            self.add_module(name, seq)
            return out

        inplanes = int(64 * s)
        _add_stem(self, in_channels, inplanes)
        c = stage("layer1", inplanes, int(128 * s), layers[0], 1, img_size // 2, mode)
        c = stage("layer2", c, int(256 * s), layers[1], 2, img_size // 2, mode)
        self.decoder4 = nn.Conv2d(c, int(128 * e * s), 3, padding=1)
        self.decoder5 = nn.Conv2d(int(128 * e * s), int(64 * e * s), 3, padding=1)

        ks0 = patch_size // 2
        inplanes_p = int(256 * s) * e
        _add_stem(self, in_channels, inplanes_p, "_p")
        c = stage("layer1_p", inplanes_p, int(128 * s), layers[0], 1, ks0, mode_local)
        c = stage("layer2_p", c, int(256 * s), layers[1], 2, ks0, mode_local)
        c = stage("layer3_p", c, int(512 * s), layers[2], 2, ks0 // 2, mode_local)
        c = stage("layer4_p", c, int(1024 * s), layers[3], 2, ks0 // 4, mode_local)
        chans = [c, int(1024 * e * s), int(512 * e * s), int(256 * e * s), int(128 * e * s),
                 int(64 * e * s)]
        for d in range(1, 6):
            self.add_module(f"decoder{d}_p", nn.Conv2d(chans[d - 1], chans[d], 3,
                                                       stride=2 if d == 1 else 1, padding=1))
        out = int(64 * e * s)
        self.decoderf = nn.Conv2d(out, out, 3, padding=1)
        self.adjust = nn.Conv2d(out, num_classes, 1)

    def _dec(self, z: torch.Tensor, name: str) -> torch.Tensor:
        return torch.relu(_up2(conv(z, getattr(self, name), self.dtype)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, C, H, W] images, H and W multiples of ``patch_size``."""
        dt, p = self.dtype, self.patch_size
        x = x.to(dtype=dt, memory_format=torch.channels_last)
        b, c_in, h, w = x.shape
        if h % p or w % p:
            raise ValueError(f"LoGo needs image size divisible by {p}")

        x1 = self.layer1(_stem(self, x, dt))
        x2 = self.layer2(x1)
        glob = self._dec(self._dec(x2, "decoder4") + x1, "decoder5")

        nh, nw = h // p, w // p
        xp = x.reshape(b, c_in, nh, p, nw, p).permute(0, 2, 4, 1, 3, 5)
        xp = xp.reshape(b * nh * nw, c_in, p, p).contiguous(memory_format=torch.channels_last)
        x1p = self.layer1_p(_stem(self, xp, dt, "_p"))
        x2p = self.layer2_p(x1p)
        x3p = self.layer3_p(x2p)
        x4p = self.layer4_p(x3p)
        u = self._dec(x4p, "decoder1_p") + x4p
        u = self._dec(u, "decoder2_p") + x3p
        u = self._dec(u, "decoder3_p") + x2p
        u = self._dec(u, "decoder4_p") + x1p
        u = self._dec(u, "decoder5_p")
        c_out = u.shape[1]
        loc = u.reshape(b, nh, nw, c_out, p, p).permute(0, 3, 1, 4, 2, 5).reshape(b, c_out, h, w)

        fused = torch.relu(conv(glob + loc, self.decoderf, dt))
        return {"main": conv(torch.relu(fused), self.adjust, dt)}
