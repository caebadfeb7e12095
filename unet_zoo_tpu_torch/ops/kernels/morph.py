"""K5: channel softmax, then ``repeat`` rounds of k x k dilation and erosion.

    sm = softmax_C(x); d = maxpool_k^repeat(sm); e = -maxpool_k^repeat(-sm)

each pool with SAME -inf padding, as ``max_pool2d(x, k, 1, k // 2)``.
Counterpart of ``unet_zoo_tpu/ops/pallas/morph.py::fused_softmax_morph``.
On a CUDA tensor :func:`fused_softmax_morph` launches the hand-written
Hopper kernel in ``csrc/morph.cu`` (a statistics grid, then a pool grid
that streams rows), laid out by :func:`plan`; on a CPU tensor it runs
:func:`fused_softmax_morph_reference`, the plain PyTorch version.
Activations are logical NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build, refuse_export

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"fused_softmax_morph": 0}

# Channel counts the kernel takes: whole 8-channel (16-byte) vectors.
CHANNEL_ALIGN = 8
HALF = 3                  # the kernel's window is 7 x 7
NS = 4                    # input rows a pool block stages ahead (csrc/morph.cu)
SMEM_LIMIT = 232448       # an H100 block's dynamic shared memory
STATS_THREADS = 256       # threads of a statistics block (csrc/morph.cu)
# A plan gives the pool grid at least this many blocks where it can (about
# one for each of an H100's 132 SMs), then reads the fewest input cells.
TARGET_BLOCKS = 128
STRIP_WIDTHS = (16, 32, 64)
# A pool block holds at least this many channels where C has them: 48
# contiguous bytes of a pixel, at least one whole 32-byte sector.
MIN_CB = 24
BAND_HEIGHTS = (8, 16, 32, 64, 128)


class MorphPlan(NamedTuple):
    """How one K5 launch runs (csrc/morph.cu)."""

    cb: int          # channels a pool block holds
    tw: int          # output columns of a strip
    bh: int          # output rows of a band
    rows: int        # input rows a band walks: bh + 2R (R = 3 * repeat)
    lanes: int       # statistics grid: lanes of a warp that share a pixel
    grid: Tuple[int, int, int]   # pool grid: (strips * bands, C / cb, B)
    threads: int     # pool block: (tw + 2R) * cb / 8, one 16-byte cell each
    smem: int        # pool block's dynamic shared memory in bytes
    stats_blocks: int  # statistics grid's blocks


def fused_softmax_morph_reference(x: torch.Tensor, k: int = 7, repeat: int = 1
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: float32 softmax and pools; returns
    (dilate, erode) in ``x.dtype``, channels_last."""
    sm = torch.softmax(x.float(), dim=1)
    d, e = sm, sm
    for _ in range(repeat):
        d = F.max_pool2d(d, k, 1, k // 2)
        e = -F.max_pool2d(-e, k, 1, k // 2)
    cl = torch.channels_last
    return d.to(x.dtype).contiguous(memory_format=cl), e.to(x.dtype).contiguous(memory_format=cl)


def max_threads(repeat: int) -> int:
    """A pool block's threads at most (csrc/morph.cu ``max_threads``): a
    second round's sliding windows need more registers a thread."""
    return 512 if repeat == 1 else 256


def pool_smem(cells: int, repeat: int) -> int:
    """A pool block's shared memory (csrc/morph.cu ``pool_smem``): NS staged
    rows of 16-byte cells and their statistics (8 bytes a cell), and for a
    second round round 1's row of d and e."""
    return NS * cells * (16 + 8) + (2 * cells * 16 if repeat == 2 else 0)


def stats_lanes(c: int) -> int:
    """Lanes of a warp that share a pixel in the statistics grid: the
    largest power of two dividing C / 8, at most 32."""
    chunks = c // CHANNEL_ALIGN
    return min(32, chunks & -chunks)


def _layout(b, c, h, w, repeat, cb, tw, bh) -> MorphPlan:
    r = HALF * repeat
    cells = (tw + 2 * r) * (cb // CHANNEL_ALIGN)
    lanes = stats_lanes(c)
    pix_per_block = STATS_THREADS // 32 * (32 // lanes)
    return MorphPlan(cb, tw, bh, bh + 2 * r, lanes, (-(-w // tw) * -(-h // bh), c // cb, b),
                     cells, pool_smem(cells, repeat), -(-b * h * w // pix_per_block))


@functools.lru_cache(maxsize=256)
def plan(b: int, c: int, h: int, w: int, repeat: int) -> MorphPlan:
    """The launch for x [B, C, H, W]: among strip widths, channel blocks
    (multiples of 8 dividing C whose staged row has at most
    ``max_threads(repeat)`` cells) and band heights, the one whose staged
    rows read the fewest 16-byte cells of those whose pool grid has at least
    TARGET_BLOCKS blocks (ties: more channels, then wider strips); if none
    has, the one with the most blocks. Blocks of at least MIN_CB channels
    are searched first, the narrower ones only where none of those fits."""
    r = HALF * repeat
    blocks_of = [cb for cb in range(c, 0, -CHANNEL_ALIGN) if c % cb == 0]
    for candidates in ([cb for cb in blocks_of if cb >= MIN_CB], blocks_of):
        best = None
        for tw in sorted({min(w, t) for t in STRIP_WIDTHS}):
            for cb in candidates:
                if (tw + 2 * r) * (cb // CHANNEL_ALIGN) > max_threads(repeat):
                    continue
                for bh in sorted({min(h, t) for t in BAND_HEIGHTS}):
                    p = _layout(b, c, h, w, repeat, cb, tw, bh)
                    blocks = p.grid[0] * p.grid[1] * p.grid[2]
                    cells = blocks * p.rows * p.threads
                    key = (blocks < TARGET_BLOCKS, -blocks if blocks < TARGET_BLOCKS else cells,
                           -cb, -tw)
                    if best is None or key < best[0]:
                        best = (key, p)
        if best is not None:
            return best[1]
    raise ValueError(f"no K5 plan for C={c}, repeat={repeat}")


def _check_kernel_args(x, k, repeat):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be torch.bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("x must be channels_last contiguous and 16-byte aligned")
    b, c, h, w = x.shape
    if c % CHANNEL_ALIGN:
        raise ValueError(f"C={c} must be a multiple of {CHANNEL_ALIGN}")
    if k != 7 or repeat not in (1, 2):
        raise ValueError(f"the kernel takes k = 7 and repeat in (1, 2), "
                         f"got k={k}, repeat={repeat}")
    if x.numel() >= 2**31:
        raise ValueError("tensors above 2^31 elements are not supported")
    return b, c, h, w


def _lib():
    lib = build.library("morph")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.softmax_morph.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.softmax_morph.restype = i
        lib.softmax_morph_short_halo.argtypes = [p, p, p, p] + [i] * 10 + [p]
        lib.softmax_morph_short_halo.restype = i
        lib.softmax_morph_geometry.argtypes = [i] * 9 + [ctypes.POINTER(ctypes.c_int)]
        lib.softmax_morph_geometry.restype = None
        lib._typed = True
    return lib


def source_geometry(b, c, h, w, repeat, p: MorphPlan) -> Tuple[int, ...]:
    """The source's own numbers for plan ``p``: (grid x, y, z, threads,
    shared memory, statistics blocks, rows), as :class:`MorphPlan` has them."""
    out = (ctypes.c_int * 7)()
    _lib().softmax_morph_geometry(b, h, w, c, repeat, p.cb, p.tw, p.bh, p.lanes, out)
    return tuple(out)


def _run(x: torch.Tensor, repeat: int, p: MorphPlan, *short_halo: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K5 call on CUDA tensor ``x`` laid out by ``p`` (checked); with
    ``short_halo`` the source's fault entry instead."""
    b, c, h, w = x.shape
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        d = torch.empty_like(x, memory_format=torch.channels_last)
        e = torch.empty_like(x, memory_format=torch.channels_last)
        stats = torch.empty(2 * b * h * w, dtype=torch.float32, device=x.device)
        entry = lib.softmax_morph_short_halo if short_halo else lib.softmax_morph
        err = entry(x.data_ptr(), d.data_ptr(), e.data_ptr(), stats.data_ptr(), b, h, w, c,
                    repeat, p.cb, p.tw, p.bh, p.lanes, *short_halo, stream)
        if err:
            raise RuntimeError(f"softmax_morph launch failed: cudaError {err}")
    return d, e


def _launch(x: torch.Tensor, repeat: int, p: MorphPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K5 call, counted in LAUNCHES."""
    d, e = _run(x, repeat, p)
    LAUNCHES["fused_softmax_morph"] += 1
    return d, e


def short_halo_fault(x: torch.Tensor, repeat: int, side: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A planted fault for the card checks: the kernel with the strip's
    (``side="strip"``) or the band's (``"band"``) halo one pixel short of
    R = 3 * repeat. Not counted in LAUNCHES."""
    b, c, h, w = _check_kernel_args(x, 7, repeat)
    return _run(x, repeat, plan(b, c, h, w, repeat), {"strip": 1, "band": 2}[side])


def fused_softmax_morph(x: torch.Tensor, k: int = 7, repeat: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax over C, then ``repeat`` rounds of k x k (dilate, erode).

    x: [B, C, H, W] channels_last; returns (dilate, erode), each like x.
    CUDA tensors run the kernel (bf16, k = 7, repeat 1 or 2: mmunet's
    gates; anything else raises); CPU tensors run the reference.
    """
    refuse_export("K5 (fused_softmax_morph)", x)
    if x.device.type == "cpu":
        return fused_softmax_morph_reference(x, k, repeat)
    if x.device.type != "cuda":
        raise ValueError(f"fused_softmax_morph runs on cuda or cpu, not {x.device}")
    b, c, h, w = _check_kernel_args(x, k, repeat)
    return _launch(x, repeat, plan(b, c, h, w, repeat))
