"""K4: mmunet's MKBlock in eval, fused.

    a = gelu(s1 * dw3(x1) + t1); b = gelu(s2 * dw5(a + x2) + t2)
    c = gelu(s3 * dw7(b + x3) + t3); h0 = bf16([a | b | c | x4])
    out = x + bf16(gelu(h0 @ w1 + b1)) @ w2 + b2

Counterpart of ``unet_zoo_tpu/ops/pallas/mkblock.py::fused_mkblock`` with
``fold_mkblock_params``. On a CUDA tensor :func:`fused_mkblock` launches the
hand-written Hopper kernel in ``csrc/mkblock.cu``: the depthwise cascade into
a bf16 ``h0``, then the pointwise MLP on wgmma in the form :func:`plan`
picks (C <= 192: one persistent grid whose hidden layer stays in registers;
C > 192: two GEMM grids through a bf16 hidden layer, the second one's K split
over blocks and summed in a fixed order where its tiles would not fill the
card). The kernel reads w1 and w2 K-contiguous (:func:`pack_mkblock_weights`,
once per frozen block). On a CPU tensor it runs
:func:`fused_mkblock_reference`, the plain PyTorch version. Activations are
logical NCHW in ``channels_last`` memory.

Both round ``h0`` and the hidden layer to bfloat16 before each product, as
the TPU kernel does (``mkblock.py:127,141`` there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build, refuse_export

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"fused_mkblock": 0}

# Channel counts the kernel takes: each quarter holds whole 8-channel
# (16-byte) chunks.
CHANNEL_ALIGN = 32
_KERNELS = (3, 5, 7)     # the cascade's depthwise kernel sizes
_NTAPS = 9 + 25 + 49

# The MLP's forms (csrc/mkblock.cu): up to FUSED_MAX_C channels the fused
# persistent grid (its [64, C] output accumulator fits a warpgroup's
# registers), above it two GEMM grids of GEMM_BM x GEMM_BN tiles.
FUSED_MAX_C = 192
BM = 128                 # rows of a fused MLP tile: two consumer warpgroups of 64
SMEM_LIMIT = 232448      # an H100 block's dynamic shared memory
GEMM_BM = GEMM_BN = 128
GEMM_BK = 64
MIN_SPLIT_K_TILES = 8    # K boxes of GEMM_BK a split of the second GEMM gets at least


class MKBlockWeights(NamedTuple):
    """An eval-mode MKBlock folded into the kernel's operands."""

    taps: torch.Tensor    # [83, q] f32: dw3, dw5, dw7 taps, row-major per kernel
    affine: torch.Tensor  # [6, q] f32: (s1, t1, s2, t2, s3, t3)
    w1: torch.Tensor      # [C, 4C] bf16: pwconv1 with norm4's scale folded in
    b1: torch.Tensor      # [4C] f32: pwconv1 bias with norm4's shift folded in
    w2: torch.Tensor      # [4C, C] bf16: pwconv2
    b2: torch.Tensor      # [C] f32


class MKBlockPacked(NamedTuple):
    """w1 and w2 as the kernel's TMA reads them: K-contiguous."""

    w1t: torch.Tensor     # [4C, C] bf16: w1 transposed (pwconv1's own layout)
    w2t: torch.Tensor     # [C, 4C] bf16: w2 transposed (pwconv2's own layout)


class MKBlockPlan(NamedTuple):
    """How one K4 launch runs its MLP (the cascade's grid is fixed by shape)."""

    form: str        # "fused": one persistent grid; "gemm": two GEMM grids
    grid: int        # fused: persistent blocks; gemm: the second GEMM's blocks
    splits: int      # gemm: blocks splitting the second GEMM's K (1: none)
    resident: bool   # fused: w1 and w2 stay in shared memory for a block's life
    smem: int        # fused: the MLP grid's dynamic shared memory in bytes


def _bn_affine(bn):
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


@torch.no_grad()
def fold_mkblock_params(block) -> MKBlockWeights:
    """Fold an eval-mode MKBlock's parameters into the kernel's operands.

    ``block`` holds the original zoo's modules: ``dwconv1-3`` (depthwise
    ``Conv2d``), ``norm1-4`` (``BatchNorm2d``) and ``pwconv1/2``
    (``nn.Linear``). Each depthwise bias folds into its BatchNorm as
    ``(s, dwb * s + t)``; ``norm4`` folds into ``pwconv1`` as ``w1 * s4``
    and ``b4 @ w1 + b1``. The port's copy of the JAX package's fold, without
    the TPU's 128-row padding of ``w2``; weights come out as [K, N] matrices.
    """
    taps, affine = [], []
    for i, k in enumerate(_KERNELS, start=1):
        conv, bn = getattr(block, f"dwconv{i}"), getattr(block, f"norm{i}")
        taps.append(conv.weight.float().reshape(-1, k * k).t())   # [k*k, q]
        s, t = _bn_affine(bn)
        affine += [s, conv.bias.float() * s + t]
    s4, t4 = _bn_affine(block.norm4)
    w1 = block.pwconv1.weight.float()                      # [4C, C]
    return MKBlockWeights(
        taps=torch.cat(taps).contiguous(),
        affine=torch.stack(affine).contiguous(),
        w1=(w1 * s4).t().to(torch.bfloat16).contiguous(),
        b1=(w1 @ t4 + block.pwconv1.bias.float()).contiguous(),
        w2=block.pwconv2.weight.float().t().to(torch.bfloat16).contiguous(),
        b2=block.pwconv2.bias.detach().float().clone())


def pack_mkblock_weights(w1: torch.Tensor, w2: torch.Tensor) -> MKBlockPacked:
    """w1 [C, 4C] and w2 [4C, C] (as :func:`fold_mkblock_params` returns
    them) transposed to the K-contiguous layouts the kernel reads; a frozen
    block packs once (``MKBlock.freeze_kernel_weights``)."""
    return MKBlockPacked(w1.t().contiguous(), w2.t().contiguous())


def fused_layout(c: int):
    """(resident, shared memory bytes) of the fused MLP grid at C channels,
    as ``Fused<C>`` in csrc/mkblock.cu lays it out: a 1024-byte alignment
    slack; two h0 tiles of BM rows; the weights of every hidden chunk (w1^T
    rows and w2^T columns of :func:`hidden_chunk` units) where all fit, else
    a two-stage ring; two mbarriers a stage. A row of K = C bf16 is C // 64
    boxes of 128 bytes and, for an odd multiple of 32, one of 64."""
    hc = hidden_chunk(c)
    row = 128 * (c // 64) + 64 * ((c % 64) // 32)
    nchunk = 4 * c // hc
    a_bytes, w_bytes = BM * row, hc * row + c * hc * 2
    resident = 1024 + 2 * a_bytes + nchunk * w_bytes + 16 * (2 + nchunk) <= SMEM_LIMIT
    stages = nchunk if resident else 2
    return resident, 1024 + 2 * a_bytes + stages * w_bytes + 16 * (2 + stages)


def hidden_chunk(c: int) -> int:
    """Hidden units of a fused chunk (GEMM1's wgmma N): 128 where its
    accumulator fits beside the [64, C] output accumulator (C <= 96)."""
    return 128 if c <= 96 else 64


@functools.lru_cache(maxsize=256)
def plan(m: int, c: int, sm_count: int) -> MKBlockPlan:
    """The MLP's form for M = B*H*W rows of C channels on a card of
    ``sm_count`` SMs. Fused (C <= FUSED_MAX_C): one block an SM, at most one
    per 128-row tile. GEMM: the second GEMM ([M, 4C] x [4C, C]) splits its K
    over as many blocks as keep the card's SMs busy beside its output tiles,
    each split at least MIN_SPLIT_K_TILES boxes of K."""
    if c <= FUSED_MAX_C:
        resident, smem = fused_layout(c)
        return MKBlockPlan("fused", min(-(-m // BM), sm_count), 1, resident, smem)
    out_tiles = -(-m // GEMM_BM) * -(-c // GEMM_BN)
    splits = max(1, min(sm_count // out_tiles, 4 * c // GEMM_BK // MIN_SPLIT_K_TILES))
    return MKBlockPlan("gemm", out_tiles * splits, splits, False, 0)


def fused_mkblock_reference(x, taps, affine, w1, b1, w2, b2):
    """Plain PyTorch version of K4 (same arguments as the kernel wrapper).

    float32 arithmetic, with ``h0`` and the hidden layer rounded to bfloat16
    before each product as the kernel does; zero padding for each depthwise
    conv. Returns ``x.dtype``, channels_last.
    """
    q = x.shape[1] // 4
    xf = x.float()
    quarters = xf.split(q, dim=1)
    aff = affine.float().view(6, 1, q, 1, 1)
    z, outs, kbase = None, [], 0
    for i, k in enumerate(_KERNELS):
        wt = taps[kbase:kbase + k * k].float().t().reshape(q, 1, k, k)
        kbase += k * k
        inp = quarters[i] if z is None else z + quarters[i]
        z = F.gelu(F.conv2d(inp, wt, padding=k // 2, groups=q) * aff[2 * i] + aff[2 * i + 1])
        outs.append(z)
    h0 = torch.cat(outs + [quarters[3]], dim=1).permute(0, 2, 3, 1)
    h0 = h0.to(torch.bfloat16).float()
    hid = F.gelu(h0 @ w1.float() + b1.float()).to(torch.bfloat16).float()
    out = xf + (hid @ w2.float() + b2.float()).permute(0, 3, 1, 2)
    return out.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _check_kernel_args(x, taps, affine, w1, b1, w2, b2, packed=None):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % CHANNEL_ALIGN:
        raise ValueError(f"C={c} must be a multiple of {CHANNEL_ALIGN}")
    q = c // 4
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    args = [("taps", taps, f32, (_NTAPS, q)), ("affine", affine, f32, (6, q)),
            ("w1", w1, bf16, (c, 4 * c)), ("b1", b1, f32, (4 * c,)),
            ("w2", w2, bf16, (4 * c, c)), ("b2", b2, f32, (c,))]
    if packed is not None:
        args += [("w1t", packed.w1t, bf16, (4 * c, c)), ("w2t", packed.w2t, bf16, (c, 4 * c))]
    for name, t, dt, shape in args:
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape} for C={c}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != bf16:
        raise TypeError(f"x must be {bf16}, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("x must be channels_last contiguous and 16-byte aligned")
    if b * h * w >= 2**31:
        raise ValueError("B*H*W must stay below 2^31: the kernel's row index is an int")
    return b, c, h, w


def _lib():
    lib = build.library("mkblock")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mkblock_forward.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.mkblock_forward.restype = i
        for fn in (lib.mkblock_fused_smem, lib.mkblock_fused_resident):
            fn.argtypes = [i]
            fn.restype = i
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_mkblock(x, taps, affine, w1, b1, w2, b2, packed: Optional[MKBlockPacked] = None):
    """The MKBlock base in eval: x [B, C, H, W] channels_last; the rest as
    :func:`fold_mkblock_params` returns them; ``packed`` w1 and w2 as
    :func:`pack_mkblock_weights` returns them (packed here when not given).
    Returns [B, C, H, W] channels_last in ``x.dtype``.

    CUDA tensors run the kernel (bf16 x and w1/w2, float32 taps, affine and
    biases; anything else raises); CPU tensors run the reference.
    """
    refuse_export("K4 (fused_mkblock)", x)
    if x.device.type == "cpu":
        return fused_mkblock_reference(x, taps, affine, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mkblock runs on cuda or cpu, not {x.device}")
    b, c, h, w = _check_kernel_args(x, taps, affine, w1, b1, w2, b2, packed)
    if packed is None:
        packed = pack_mkblock_weights(w1, w2)
    lib = _lib()
    m = b * h * w
    with torch.cuda.device(x.device):
        p = plan(m, c, _sm_count(x.device.index))
        # one scratch buffer: h0 [M, C] bf16, then, in the two-GEMM form only,
        # the hidden layer [M, 4C] bf16 and the split second GEMM's f32
        # partials [splits, M, C], each at a 256-byte boundary
        sizes = [m * c * 2, m * 4 * c * 2 if p.form == "gemm" else 0,
                 p.splits * m * c * 4 if p.splits > 1 else 0]
        offsets = [0]
        for size in sizes[:-1]:
            offsets.append(offsets[-1] + -(-size // 256) * 256)
        scratch = torch.empty(offsets[-1] + sizes[-1], dtype=torch.uint8, device=x.device)
        h0, hid, ws = (scratch.data_ptr() + o if size else None for o, size in zip(offsets, sizes))
        out = torch.empty_like(x, memory_format=torch.channels_last)
        err = lib.mkblock_forward(x.data_ptr(), taps.data_ptr(), affine.data_ptr(),
                                  packed.w1t.data_ptr(), b1.data_ptr(), packed.w2t.data_ptr(),
                                  b2.data_ptr(), h0, hid, ws, out.data_ptr(), b, h, w, c, p.grid,
                                  p.splits, torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"mkblock_forward launch failed: error {err}")
    LAUNCHES["fused_mkblock"] += 1
    return out
