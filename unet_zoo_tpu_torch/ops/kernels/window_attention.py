"""K2: SwinV2 cosine window attention, fused.

For each window b, head h and query i:

    a[i, j] = (q_i·k_j / max(|q_i| |k_j|, 1e-6)) / max(tau[h,i,j], 0.01)
              + bias[h,i,j] + mask[b % nW, i, j]
    out[i]  = Σ_j softmax_j(a[i, :]) v_j

with q already multiplied by the attention scale (it cancels in the cosine
but for the 1e-6 clamp), ``tau`` a per-element divisor clipped from below
only, ``bias`` the continuous relative position bias (the CPB table) and
``mask`` the 0 / -100 shift mask, absent for unshifted windows. Norms,
logits and the softmax are float32; the output is rounded to the input type
once. Counterpart of ``unet_zoo_tpu/ops/pallas/window_attention.py::
swin_window_attention``.

On a CUDA tensor :func:`swin_window_attention` launches one grid of the
hand-written Hopper kernel in ``csrc/window_attention.cu``; on a CPU tensor
it runs :func:`swin_window_attention_reference`, the plain PyTorch version.
The source has two instances and :func:`instance` picks one by shape, type
and alignment: ``"mma"`` (bf16, N <= 64, hd 16 or 32, 16-byte aligned rows:
both products on the tensor cores, several windows of one head a block, laid
out by :func:`plan`) and ``"general"`` (everything else the wrapper takes:
one block per (window, head), float32 FMAs). q, k and v are [B_, nh, N, hd]
as in JAX, in any strides whose last one is 1, so the model hands over views
of its qkv projection.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from unet_zoo_tpu_torch.ops.kernels import build, refuse_export

# Times the wrapper launched the CUDA kernel, in all and by instance (read by
# chip_smoke.py).
LAUNCHES = {"swin_window_attention": 0, "swin_window_attention_mma": 0,
            "swin_window_attention_general": 0}

MAX_TOKENS = 256        # N: 8 keys per lane of a warp (the general instance)
MAX_HEAD_DIM = 128
_NWARPS = 4             # warps of a general block (csrc/window_attention.cu)
_SMEM_LIMIT = 200 * 1024

# The mma instance (csrc/window_attention.cu): a window padded to 64 tokens,
# 4 warps of 16 query rows, RING staged windows of q, k and v.
MMA_MAX_TOKENS = 64
MMA_HEAD_DIMS = (16, 32)
MMA_THREADS = 128
MMA_ROWS = 64
RING = 3                # PREFETCH + 2 in the source: one window in flight
# plan(): the H100's SMs; the resident blocks an SM needs before the window
# chains' latency stops setting its time; a head's table read in windows of
# work; the most windows a block takes.
SMS = 132
BUSY_BLOCKS = 3
TABLE_COST = 0.5
MAX_WINDOWS_PER_BLOCK = 8


# The source's planted faults of the mma instance (FAULT_MASK, FAULT_P_ONCE)
FAULTS = {"one mask a block": 1, "P rounded once": 2}


class K2Plan(NamedTuple):
    """How one launch of the mma instance runs (csrc/window_attention.cu)."""

    windows_per_block: int   # windows of one (head, mask index) group a block takes
    per_group: int           # windows of a group: B_ / nW (B_ without a mask)
    chunks: int              # blocks a group: ceil(per_group / windows_per_block)
    grid: int                # blocks: nh * nW * chunks
    threads: int
    smem: int                # dynamic shared memory of a block in bytes


def _clip_tau(tau: torch.Tensor) -> torch.Tensor:
    """``clip(tau, 0.01)``: a lower bound only, as float32."""
    return tau.float().clamp_min(0.01)


def swin_window_attention_reference(q, k, v, tau, bias, mask=None) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arguments as the kernel wrapper):
    float32 throughout, as ``window_attention.py:114-128``; returns
    [B_, nh, N, hd] in ``q.dtype``. ``mask`` None is no mask."""
    b_, nh, n, _ = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    dots = q32 @ k32.transpose(-1, -2)
    qn = torch.linalg.vector_norm(q32, dim=-1)[..., :, None]
    kn = torch.linalg.vector_norm(k32, dim=-1)[..., None, :]
    attn = dots / torch.clamp_min(qn * kn, 1e-6)
    attn = attn / _clip_tau(tau)[None]
    attn = attn + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask.float()[None, :, None]
        attn = attn.reshape(b_, nh, n, n)
    attn = torch.softmax(attn, dim=-1)
    return (attn @ v32).to(q.dtype)


def smem_bytes(n: int, hd: int) -> int:
    """Shared memory of one general block (``smem_bytes`` in
    csrc/window_attention.cu)."""
    ld = hd | 1
    return 4 * (2 * n * ld + n * hd + 2 * n + _NWARPS * n)


def _check_kernel_args(q, k, v, tau, bias, mask):
    """The kernel's argument checks; every error names the module path."""
    def fail(msg):
        raise ValueError(f"{msg}; use_kernels=False runs such a model on its module path")

    if q.dim() != 4:
        fail(f"q must be [B_, nh, N, hd], got {tuple(q.shape)}")
    b_, nh, n, hd = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            fail(f"{name} is {tuple(t.shape)}, q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            fail(f"q, k and v must share torch.bfloat16 or torch.float32, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            fail(f"{name}'s last dimension must be contiguous")
        if t.device != q.device:
            fail(f"{name} is on {t.device}, q on {q.device}")
    if not 1 <= n <= MAX_TOKENS:
        fail(f"the K2 kernel takes windows of up to {MAX_TOKENS} tokens, not {n}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        fail(f"the K2 kernel takes head widths up to {MAX_HEAD_DIM}, not {hd}")
    if smem_bytes(n, hd) > _SMEM_LIMIT:
        fail(f"N={n}, hd={hd} does not fit the K2 kernel's shared memory")
    nw = 1
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n) or mask.shape[0] < 1:
            fail(f"mask must be [nW, {n}, {n}], got {tuple(mask.shape)}")
        nw = mask.shape[0]
        if b_ % nw:
            fail(f"nW={nw} does not divide B_={b_}")
    for name, t, shape in (("tau", tau, (nh, n, n)), ("bias", bias, (nh, n, n)),
                           ("mask", mask, None)):
        if t is None:
            continue
        if shape is not None and tuple(t.shape) != shape:
            fail(f"{name} is {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            fail(f"{name} must be torch.float32, got {t.dtype}")
        if t.device != q.device:
            fail(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            fail(f"{name} must be contiguous")
    if b_ * nh >= 2**31:
        fail("more than 2^31 (window, head) pairs")
    return b_, nh, n, hd, nw


def mma_smem_bytes(hd: int) -> int:
    """Shared memory of one mma block (``mma_smem`` in csrc/window_attention.cu):
    RING slots of q, k and v as [64][hd + 8] bf16."""
    return 2 * RING * 3 * MMA_ROWS * (hd + 8)


def layout(b_: int, nh: int, hd: int, nw: int, windows_per_block: int) -> K2Plan:
    """The mma launch for ``windows_per_block`` windows a block; ``nw`` is 1
    where there is no mask."""
    per_group = b_ // nw
    chunks = -(-per_group // windows_per_block)
    return K2Plan(windows_per_block, per_group, chunks, nh * nw * chunks, MMA_THREADS,
                  mma_smem_bytes(hd))


@functools.lru_cache(maxsize=256)
def plan(b_: int, nh: int, n: int, hd: int, nw: int) -> K2Plan:
    """The mma launch for [B_, nh, N, hd] with ``nw`` mask windows (1 without
    a mask). A block takes windows b = m + nW t of one head and mask index m,
    so it reads that head's tables and mask once. Among 1 to
    MAX_WINDOWS_PER_BLOCK windows a block, whose grids have at least
    min(SMS, B_ nh) blocks, the one with the least estimated time on the
    busiest SM: windows a block x max(blocks an SM, BUSY_BLOCKS), plus
    TABLE_COST a block; ties go to more windows a block."""
    if not (1 <= n <= MMA_MAX_TOKENS and hd in MMA_HEAD_DIMS and nw >= 1 and b_ % nw == 0):
        raise ValueError(f"no mma plan for B_={b_}, N={n}, hd={hd}, nW={nw}")
    best = None
    for wpb in range(1, min(MAX_WINDOWS_PER_BLOCK, b_ // nw) + 1):
        p = layout(b_, nh, hd, nw, wpb)
        if p.grid < min(SMS, b_ * nh):
            continue
        per_sm = -(-p.grid // SMS)
        key = (wpb * max(per_sm, BUSY_BLOCKS) + TABLE_COST * per_sm, -wpb)
        if best is None or key < best[0]:
            best = (key, p)
    return best[1]


def instance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The instance a launch on these (checked) operands runs: ``"mma"`` for
    bf16 with N <= 64, hd 16 or 32 and 16-byte aligned rows of q, k and v
    (data pointers and (window, head, token) strides); ``"general"``
    otherwise."""
    _, _, n, hd = q.shape
    if q.dtype != torch.bfloat16 or n > MMA_MAX_TOKENS or hd not in MMA_HEAD_DIMS:
        return "general"
    bits = q.data_ptr() | k.data_ptr() | v.data_ptr()
    for t in (q, k, v):
        s0, s1, s2, _ = t.stride()
        bits |= 2 * (s0 | s1 | s2)      # in bytes of a bf16 element
    return "mma" if bits % 16 == 0 else "general"


def launch_shapes(image: int, window: int, batch: int, embed_dim: int = 96,
                  depths: Sequence[int] = (2, 2, 2, 2),
                  num_heads: Sequence[int] = (3, 6, 12, 24), patch_size: int = 4):
    """K2's launches in one ``swin_unet_v2`` forward of ``batch`` images (the
    registry defaults unless given): rows of (B_, nh, N, hd, nW, launches),
    nW 1 for an unshifted block (no mask). Every stage runs its blocks in the
    encoder, and all but the last again in the decoder; the odd blocks of a
    stage shift, unless the window covers the stage."""
    rows = []
    for stage, (depth, nh) in enumerate(zip(depths, num_heads)):
        res = image // patch_size >> stage
        w = min(window, res)
        nw, layers = (res // w) ** 2, 2 if stage < len(depths) - 1 else 1
        shape = (batch * nw, nh, w * w, embed_dim * 2 ** stage // nh)
        shifted = depth // 2 if res > window else 0
        if shifted:
            rows.append((*shape, nw, shifted * layers))
        rows.append((*shape, 1, (depth - shifted) * layers))
    return rows


def work(b_: int, nh: int, n: int, hd: int, nw: int) -> Tuple[int, int, int]:
    """K2's function, whatever implements it: (tensor-core FLOPs, float32
    operations, least bytes). q·k from the bf16 q and k could run on the
    tensor cores (exact products); P·V is float32 (P is not rounded), and so
    are the norms (4 hd per token) and about 10 operations per (i, j): the
    cosine's divide, tau, bias, mask, max, exp, sum and the normalisation.
    Bytes: q, k, v read and the output written once (bf16), tau and bias
    [nh, N, N] and the mask [nW, N, N] once (float32); ``nw`` 1 is no mask."""
    pairs = b_ * nh
    return (2 * pairs * n * n * hd, pairs * (n * n * (2 * hd + 10) + 4 * n * hd),
            2 * 4 * pairs * n * hd + 4 * (2 * nh + (nw if nw > 1 else 0)) * n * n)


def _lib():
    lib = build.library("window_attention")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for entry in (lib.window_attention_mma, lib.window_attention_general):
            entry.argtypes = [p] * 7 + [i] * 6 + [ll] * 12 + [p]
            entry.restype = i
        lib.window_attention_fault.argtypes = [p] * 7 + [i] * 6 + [ll] * 12 + [i, p]
        lib.window_attention_fault.restype = i
        lib.window_attention_geometry.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.window_attention_geometry.restype = None
        lib._typed = True
    return lib


def source_geometry(b_: int, nh: int, hd: int, nw: int, masked: bool,
                    windows_per_block: int) -> Tuple[int, ...]:
    """The source's own numbers for the mma launch: (grid, threads, shared
    memory, windows a group, blocks a group), as :class:`K2Plan` has them."""
    out = (ctypes.c_int * 5)()
    _lib().window_attention_geometry(b_, nh, hd, nw, int(masked), windows_per_block, out)
    return tuple(out)


def _run(entry: str, dims, q, k, v, tau, bias, mask, *ints: int) -> torch.Tensor:
    """One launch of the source's C entry ``entry`` on CUDA operands checked
    to ``dims`` = (B_, nh, N, hd, nW); ``ints`` are the entry's own: windows a
    block (``window_attention_mma``; ``window_attention_fault``, then the
    fault after the strides) or is_f32 (``window_attention_general``)."""
    b_, nh, n, hd, nw = dims
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # [B_, nh, N, hd] over token-major [B_, N, nh, hd] memory
        ostr = (n * nh * hd, hd, nh * hd)
        out = torch.empty_strided((b_, nh, n, hd), (*ostr, 1), dtype=q.dtype, device=q.device)
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *ostr)
        err = getattr(_lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tau.data_ptr(),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            b_, nh, n, hd, nw, ints[0], *strides, *ints[1:], stream)
        if err:
            raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out


def planted_fault(fault: str, q, k, v, tau, bias, mask=None) -> torch.Tensor:
    """The mma instance with a planted fault of :data:`FAULTS`, for the card
    checks (the source's ``window_attention_fault``, a template flag): "one
    mask a block" makes a block's windows consecutive (b = m T + t) while
    they keep the group's mask index m; "P rounded once" drops P_lo. Not
    counted in LAUNCHES."""
    dims = _check_kernel_args(q, k, v, tau, bias, mask)
    if instance(q, k, v) != "mma":
        raise ValueError("the planted faults run only the mma instance")
    return _run("window_attention_fault", dims, q, k, v, tau, bias, mask,
                plan(*dims).windows_per_block, FAULTS[fault])


def swin_window_attention(q, k, v, tau, bias, mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """SwinV2 window attention of every (window, head).

    q, k, v: [B_, nh, N, hd] (q already scaled), B_ = batch x windows;
    tau, bias: [nh, N, N] float32; mask: [nW, N, N] float32 with nW
    dividing B_ (window b reads ``mask[b % nW]``), or None. Returns [B_,
    nh, N, hd] in ``q.dtype``; on the card its memory is [B_, N, nh, hd],
    the token-major layout the output projection reads.

    CUDA tensors run the kernel's instance that :func:`instance` names
    (bf16 or float32 q, k, v; anything the kernel does not take raises),
    the mma instance as :func:`plan` lays it out. CPU tensors run the
    reference.
    """
    refuse_export("K2 (swin_window_attention)", q)
    if q.device.type == "cpu":
        return swin_window_attention_reference(q, k, v, tau, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"swin_window_attention runs on cuda or cpu, not {q.device}")
    dims = _check_kernel_args(q, k, v, tau, bias, mask)
    if instance(q, k, v) == "mma":
        out = _run("window_attention_mma", dims, q, k, v, tau, bias, mask,
                   plan(*dims).windows_per_block)
        LAUNCHES["swin_window_attention_mma"] += 1
    else:
        out = _run("window_attention_general", dims, q, k, v, tau, bias, mask,
                   int(q.dtype == torch.float32))
        LAUNCHES["swin_window_attention_general"] += 1
    LAUNCHES["swin_window_attention"] += 1
    return out
