"""K6: MedT axial attention along one image axis, in eval, fused.

For each row n of the axis pass (an image column for the height pass, an
image row for the width pass), group g and query position i:

    sim[n,g,i,:] = softmax_j( a_qk[g] Σ_c q·k + a_qr[g] Σ_c q[c,i]·q_emb[c,i,j]
                              + a_kr[g] Σ_c k[c,j]·k_emb[c,j,i] )
    out[n,i,g,p] = a_sv[g,p] Σ_j sim·v[j,p] + a_sve[g,p] Σ_j sim·v_emb[p,i,j]
                   + shift[g,p]

with ``emb[c,a,b] = relative[c, a - b + ks - 1]`` for a, b < L: rows
``[:c]`` of ``relative`` give q_emb, ``[c:gp]`` k_emb, ``[gp:]`` v_emb.
``wopos`` (``relative is None``) keeps only the qk term and sv. Counterpart
of ``unet_zoo_tpu/ops/pallas/axial_attention.py::fused_axial_attention``
with the host-side fold of ``unet_zoo_tpu/models/medt_net.py:241-279``.

The fold (:func:`fold_axial_params`) turns the eval BatchNorms and the
``gated`` scalar gates into the scales above: the similarity BN's shift is
constant over keys and drops out of the softmax; the output BN's two
shifts add, since the sv and sve channels of a pair are summed. ``bn_qkv``
folds into the qkv projection's weight and bias.

On a CUDA tensor :func:`fused_axial_attention` launches the hand-written
Hopper kernel in ``csrc/axial_attention.cu`` (one grid, one pass over the
keys, laid out by :func:`plan`); on a CPU tensor it runs
:func:`fused_axial_attention_reference`, the plain PyTorch version.
``qkv`` and the output are logical NCHW in ``channels_last`` memory, as the
1x1 projection writes them; the kernel reads both axes in place (the
height pass's transposes are strides).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from unet_zoo_tpu_torch.ops.kernels import build, refuse_export

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"fused_axial_attention": 0}

GROUP_PLANES = (2, 4, 8, 16, 32)  # gp values the kernel is built for
MAX_LENGTH = 512                  # longest axis the kernel takes
MAX_WARPS = 4                     # warps of a block (csrc/axial_attention.cu)
SMEM_LIMIT = 232448               # an H100 block's dynamic shared memory
TARGET_BLOCKS = 264               # two blocks for each of an H100's 132 SMs
# Planted faults of the source's test-only entry ``axial_attention_fault``
FAULTS = {"rescale skipped": 1, "partial key tile dropped": 2, "key-split merge dropped": 3}


class AxialWeights(NamedTuple):
    """An eval-mode AxialAttention folded into the kernel path's operands."""

    qkv_weight: torch.Tensor          # [2*out, C_in, 1, 1] compute dtype, bn_qkv folded
    qkv_bias: torch.Tensor            # [2*out] compute dtype
    relative: Optional[torch.Tensor]  # [2*gp, 2*ks - 1] f32; None for wopos
    sim_scale: torch.Tensor           # [3, g] f32: qk, qr, kr (gates folded)
    out_scale: torch.Tensor           # [2, g, gp] f32: sv, sve (gates folded)
    out_shift: torch.Tensor           # [g, gp] f32: both output shifts


def fold_bn_eval(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN with running statistics -> (a, b) with BN(x) = x * a + b (f32)."""
    a = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return a, bn.bias.float() - bn.running_mean.float() * a


@functools.lru_cache(maxsize=None)
def _relative_index(kernel_size: int) -> np.ndarray:
    """Flat index into ``relative``'s last axis: ``[a, b] -> a - b + ks - 1``."""
    q = np.arange(kernel_size)[None, :]
    k = np.arange(kernel_size)[:, None]
    return (k - q + kernel_size - 1).reshape(-1)


def relative_embeddings(relative: torch.Tensor, kernel_size: int, length: int
                        ) -> torch.Tensor:
    """``emb[c, a, b] = relative[c, a - b + ks - 1]`` for a, b < ``length``.

    The table is built at the model's ``kernel_size`` and cut to the axis
    length, so for an axis shorter than ``kernel_size`` the offset stays
    ks - 1. An axis longer than ``kernel_size`` has no embedding: raises.
    """
    if length > kernel_size:
        raise ValueError(f"axis length {length} exceeds the kernel size {kernel_size} the "
                         f"relative embeddings were built for (image larger than image_size)")
    idx = torch.from_numpy(_relative_index(kernel_size)).to(relative.device)
    emb = relative[:, idx].reshape(relative.shape[0], kernel_size, kernel_size)
    return emb[:, :length, :length]


@torch.no_grad()
def fold_axial_params(module) -> AxialWeights:
    """Fold an eval-mode AxialAttention's parameters for the kernel path.

    ``module`` holds the original zoo's names: ``qkv_transform.conv``
    (``Conv1d`` k=1), ``bn_qkv``, ``bn_similarity`` (3g channels, term-major
    ``[qk | qr | kr]``; g for ``wopos``), ``bn_output`` (2*out channels
    paired ``(g, gp, sv|sve)``; out for ``wopos``), ``relative`` and, for
    ``gated``, the scalar gates ``f_qr``, ``f_kr``, ``f_sv``, ``f_sve``.
    """
    g, out = module.groups, module.out_planes
    gp = out // g
    a_q, b_q = fold_bn_eval(module.bn_qkv)
    w = module.qkv_transform.conv.weight.float()[:, :, 0] * a_q[:, None]
    a_s, _ = fold_bn_eval(module.bn_similarity)   # the shift drops out of the softmax
    a_o, b_o = fold_bn_eval(module.bn_output)
    if module.mode == "wopos":
        zeros = torch.zeros_like(a_s)
        sim_scale = torch.stack([a_s, zeros, zeros])
        out_scale = torch.stack([a_o.reshape(g, gp), torch.zeros(g, gp, device=a_o.device)])
        out_shift = b_o.reshape(g, gp)
        relative = None
    else:
        sim_scale = a_s.reshape(3, g)
        out_scale = a_o.reshape(g, gp, 2).movedim(-1, 0)
        out_shift = b_o.reshape(g, gp, 2).sum(-1)
        if module.mode == "gated":
            sim_scale = sim_scale * torch.stack([torch.ones_like(module.f_qr.float()),
                                                 module.f_qr.float(), module.f_kr.float()])[:, None]
            out_scale = out_scale * torch.stack([module.f_sv.float(),
                                                 module.f_sve.float()])[:, None, None]
        relative = module.relative.float().contiguous()
    dt = module.dtype
    return AxialWeights(qkv_weight=w.to(dt)[:, :, None, None].contiguous(),
                        qkv_bias=b_q.to(dt), relative=relative,
                        sim_scale=sim_scale.contiguous(), out_scale=out_scale.contiguous(),
                        out_shift=out_shift.contiguous())


def axis_rows(t: torch.Tensor, width_axis: bool) -> torch.Tensor:
    """[B, C, H, W] -> [B*R, L, C]: the rows of the axis pass."""
    x = t.permute(0, 2, 3, 1)
    if not width_axis:
        x = x.transpose(1, 2)
    return x.reshape(-1, x.shape[2], x.shape[3])


def fused_axial_attention_reference(qkv, relative, sim_scale, out_scale, out_shift,
                                    kernel_size: int, width_axis: bool) -> torch.Tensor:
    """Plain PyTorch version of K6 (same arguments as the kernel wrapper).

    float32 arithmetic throughout; returns [B, g*gp, H, W] channels_last in
    ``qkv.dtype``.
    """
    b = qkv.shape[0]
    g, gp = out_scale.shape[1], out_scale.shape[2]
    c = gp // 2
    x = axis_rows(qkv.float(), width_axis)
    n, length = x.shape[0], x.shape[1]
    x = x.reshape(n, length, g, 2 * gp)
    q, k, v = x[..., :c], x[..., c:gp], x[..., gp:]
    sim_scale, out_scale, out_shift = sim_scale.float(), out_scale.float(), out_shift.float()
    sim = sim_scale[0][:, None, None] * torch.einsum("nigc,njgc->ngij", q, k)
    if relative is not None:
        emb = relative_embeddings(relative.float(), kernel_size, length)
        q_emb, k_emb, v_emb = emb[:c], emb[c:gp], emb[gp:]
        sim = sim + sim_scale[1][:, None, None] * torch.einsum("nigc,cij->ngij", q, q_emb)
        sim = sim + sim_scale[2][:, None, None] * torch.einsum("njgc,cji->ngij", k, k_emb)
    sim = torch.softmax(sim, dim=-1)                        # over keys j
    out = out_scale[0] * torch.einsum("ngij,njgp->nigp", sim, v) + out_shift
    if relative is not None:
        out = out + out_scale[1] * torch.einsum("ngij,pij->nigp", sim, v_emb)
    out = out.reshape(b, -1, length, g * gp)
    if not width_axis:
        out = out.transpose(1, 2)
    return out.permute(0, 3, 1, 2).to(qkv.dtype).contiguous(memory_format=torch.channels_last)


class AxialPlan(NamedTuple):
    """How one K6 launch runs (csrc/axial_attention.cu)."""

    rows_per_lane: int     # R: a lane's query rows, and the keys of a key tile
    tiles: int             # T = ceil(L / R) query tiles, and as many key tiles
    lanes: int             # lanes of one key split (one query tile each)
    splits: int            # key splits whose partials a query tile's lanes merge
    chunks: int            # chunks of 32 query tiles
    warps: int             # warps per group; each takes every warps-th chunk
    groups_per_block: int  # groups of one row a block holds
    grid: Tuple[int, int]  # (rows, groups / groups_per_block)
    threads: int           # 32 * groups_per_block * warps
    smem: int              # a block's dynamic shared memory in bytes


def rows_per_lane(gp: int) -> int:
    """A lane's query rows (``rows_per_lane`` in csrc/axial_attention.cu):
    the most whose logits, operands and 2 gp R sums stay in registers."""
    return 4 if gp <= 4 else 2 if gp == 8 else 1


def smem_bytes(length: int, gp: int, gb: int, wopos: bool) -> int:
    """A block's shared memory (``smem_bytes`` in csrc/axial_attention.cu):
    q|k|v of ``gb`` groups over LP positions (the length rounded up to R) as
    f32, and 2 LP columns of each of the 2 gp rows of ``relative``."""
    r = rows_per_lane(gp)
    lp = -(-length // r) * r
    return 4 * (lp * gb * 2 * gp + (0 if wopos else 2 * gp * 2 * lp))


def _pow2_ceil(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


@functools.lru_cache(maxsize=256)
def plan(rows: int, groups: int, length: int, gp: int, wopos: bool) -> AxialPlan:
    """The launch for ``rows`` rows of ``length`` positions and ``groups``
    groups of ``gp`` channels. A warp's lanes own query tiles of R rows; a
    length under 32 tiles leaves lanes over, which split the keys (a power
    of two of them, each at least one key tile); a longer one is taken in
    chunks of 32 tiles by up to MAX_WARPS warps. A block holds one row and
    the most of its groups (a divisor of ``groups``) that keeps it within
    MAX_WARPS warps and SMEM_LIMIT bytes and the grid at TARGET_BLOCKS
    blocks or more; where no grid reaches it, the fewest groups. Raises
    where not even one group fits in shared memory."""
    r = rows_per_lane(gp)
    tiles = -(-length // r)
    lanes = min(32, _pow2_ceil(tiles))
    splits = min(32 // lanes, _pow2_floor(tiles))
    chunks = -(-tiles // 32)
    warps = min(chunks, MAX_WARPS)
    fits = [d for d in range(1, groups + 1) if groups % d == 0 and d * warps <= MAX_WARPS
            and smem_bytes(length, gp, d, wopos) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"the K6 kernel does not fit an axis of {length} with gp={gp} in "
                         f"shared memory; use_kernels=False runs such a model on its module path")
    full = [d for d in fits if rows * (groups // d) >= TARGET_BLOCKS]
    gb = max(full) if full else min(fits)
    return AxialPlan(r, tiles, lanes, splits, chunks, warps, gb, (rows, groups // gb),
                     32 * gb * warps, smem_bytes(length, gp, gb, wopos))


def _check_kernel_args(qkv, relative, sim_scale, out_scale, out_shift, kernel_size,
                       width_axis):
    if qkv.dim() != 4:
        raise ValueError(f"qkv must be [B, 2*g*gp, H, W], got {tuple(qkv.shape)}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv must be torch.bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("qkv must be channels_last contiguous")
    if out_scale.dim() != 3 or out_scale.shape[0] != 2:
        raise ValueError(f"out_scale must be [2, g, gp], got {tuple(out_scale.shape)}")
    b, c2, h, w = qkv.shape
    g, gp = out_scale.shape[1], out_scale.shape[2]
    if gp not in GROUP_PLANES:
        raise ValueError(f"the K6 kernel takes group widths gp in {GROUP_PLANES}, not {gp}; "
                         f"use_kernels=False runs such a model on its module path")
    if c2 != 2 * g * gp:
        raise ValueError(f"qkv has {c2} channels, expected 2*g*gp = {2 * g * gp}")
    length = w if width_axis else h
    if length > MAX_LENGTH:
        raise ValueError(f"the K6 kernel takes axes up to {MAX_LENGTH}, not {length}; "
                         f"use_kernels=False runs such a model on its module path")
    if relative is not None and length > kernel_size:
        raise ValueError(f"axis length {length} exceeds the kernel size {kernel_size}")
    want = {"sim_scale": (3, g), "out_shift": (g, gp)}
    if relative is not None:
        want["relative"] = (2 * gp, 2 * kernel_size - 1)
    for name, t in (("relative", relative), ("sim_scale", sim_scale),
                    ("out_scale", out_scale), ("out_shift", out_shift)):
        if t is None:
            continue
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.numel() >= 2**31:
        raise ValueError("tensors above 2^31 elements are not supported")
    return b, g, gp, length


def _lib():
    lib = build.library("axial_attention")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.axial_attention.argtypes = [p] * 6 + [i] * 8 + [ll] * 6 + [p]
        lib.axial_attention.restype = i
        lib.axial_attention_fault.argtypes = [p] * 6 + [i] * 8 + [ll] * 6 + [i, p]
        lib.axial_attention_fault.restype = i
        lib.axial_attention_smem.argtypes = [i] * 4
        lib.axial_attention_smem.restype = ll
        lib._typed = True
    return lib


def source_smem(length: int, gp: int, gb: int, wopos: bool) -> int:
    """The source's own shared memory for a block of ``gb`` groups, as
    :func:`smem_bytes` has it."""
    return _lib().axial_attention_smem(length, gp, gb, int(wopos))


def _run(qkv, relative, sim_scale, out_scale, out_shift, kernel_size, width_axis, *fault):
    """One K6 call on CUDA tensors (checked, laid out by :func:`plan`); with
    ``fault`` the source's fault entry instead."""
    b, g, gp, length = _check_kernel_args(qkv, relative, sim_scale, out_scale, out_shift,
                                          kernel_size, width_axis)
    _, _, h, w = qkv.shape
    rows_per_image = h if width_axis else w
    p = plan(b * rows_per_image, g, length, gp, relative is None)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        out = torch.empty((b, g * gp, h, w), dtype=qkv.dtype, device=qkv.device,
                          memory_format=torch.channels_last)
        # element strides of (image, row, position) for the axis pass
        si, so = qkv.stride(), out.stride()
        pick = (lambda s: (s[0], s[2], s[3])) if width_axis else (lambda s: (s[0], s[3], s[2]))
        entry = lib.axial_attention_fault if fault else lib.axial_attention
        err = entry(qkv.data_ptr(), out.data_ptr(),
                    None if relative is None else relative.data_ptr(), sim_scale.data_ptr(),
                    out_scale.data_ptr(), out_shift.data_ptr(), b * rows_per_image,
                    rows_per_image, length, kernel_size, g, gp, p.groups_per_block, p.warps,
                    *pick(si), *pick(so), *fault, stream)
        if err:
            raise RuntimeError(f"axial_attention launch failed: cudaError {err}")
    return out


def planted_fault(qkv, relative, sim_scale, out_scale, out_shift, kernel_size: int,
                  width_axis: bool, fault: str) -> torch.Tensor:
    """A planted fault for the card checks: the kernel with one of
    :data:`FAULTS` (positional modes). Not counted in LAUNCHES."""
    if relative is None:
        raise ValueError("the planted faults are built for the positional modes")
    return _run(qkv, relative, sim_scale, out_scale, out_shift, kernel_size, width_axis,
                FAULTS[fault])


def fused_axial_attention(qkv, relative, sim_scale, out_scale, out_shift,
                          kernel_size: int, width_axis: bool) -> torch.Tensor:
    """One axis pass of axial attention in eval.

    qkv: [B, 2*g*gp, H, W] channels_last, per group ``[q (gp/2) | k (gp/2) |
    v (gp)]`` as the projection writes them; ``relative`` [2*gp, 2*ks - 1]
    or None (``wopos``); scales as :func:`fold_axial_params` returns them;
    ``width_axis`` attends along W, else along H. Returns [B, g*gp, H, W]
    channels_last in ``qkv.dtype``.

    CUDA tensors run the kernel (bf16 qkv, float32 tables; anything else
    raises); CPU tensors run the reference.
    """
    refuse_export("K6 (fused_axial_attention)", qkv)
    if qkv.device.type == "cpu":
        return fused_axial_attention_reference(qkv, relative, sim_scale, out_scale, out_shift,
                                               kernel_size, width_axis)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_axial_attention runs on cuda or cpu, not {qkv.device}")
    out = _run(qkv, relative, sim_scale, out_scale, out_shift, kernel_size, width_axis)
    LAUNCHES["fused_axial_attention"] += 1
    return out
