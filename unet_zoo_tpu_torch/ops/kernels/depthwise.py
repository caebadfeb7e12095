"""K3: SAME, stride-1, k x k depthwise convolution plus bias, channels-last.

    out[b, y, x, c] = sum_{dy, dx} xpad[b, y + dy, x + dx, c] * kernel[dy, dx, c] + bias[c]

x [B, H, W, C] zero-padded by (k - 1) / 2, kernel [k, k, C], bias [C] or
None; taps accumulate in float32, the bias is added in float32 and the
result is rounded to x's type once. Counterpart of
``unet_zoo_tpu/ops/pallas/depthwise.py::depthwise_conv2d``, without its
channel blocking. In bfloat16 the kernel and bias arrive rounded to
bfloat16, as the JAX ``DWConv`` casts them.

On a CUDA tensor :func:`depthwise_conv2d` launches one grid of the
hand-written Hopper kernel in ``csrc/depthwise.cu``; on a CPU tensor it runs
:func:`depthwise_conv2d_reference`, the plain PyTorch version. The source has
two instances and :func:`instance` picks one in the open: ``"stream"`` (bf16,
k = 3, C a multiple of 8, x and kernel 16-byte aligned: a row-streaming stencil laid out
by :func:`plan`) and ``"general"`` (everything else the wrapper takes: one
block per 8 x 16 output tile and 128 bytes of channels).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build, refuse_export

# Times the wrapper launched the CUDA kernel, in all and by instance (read by
# chip_smoke.py).
LAUNCHES = {"depthwise_conv2d": 0, "depthwise_conv2d_stream": 0, "depthwise_conv2d_general": 0}

KERNEL_SIZES = (3, 5, 7)

# The stream instance (csrc/depthwise.cu): 128 threads a block, TW x CV = 128
# for chunks of CV = 2^lcv 16-byte channel vectors, rings of RINGS slots;
# its launch bounds hold an SM to BLOCKS_PER_SM blocks.
STREAM_THREADS = 128
LCVS = (2, 3, 4)
RINGS = (3, 4, 6)
BLOCKS_PER_SM = 4
# plan(): the H100's SMs; the time a block takes to stream a row alone, in
# units of the time an SM's share of the card's memory rate moves it (fitted
# to the probe's sweep on an H100 80GB HBM3 at 700 W); the bytes in flight an
# SM needs (ring - 1 rows a block; the sweep's best rings hold 17-26 KB).
SMS = 132
BLOCK_ROW_COST = 2.2
INFLIGHT_BYTES = 18 * 1024

# The source's planted faults of the stream instance (FAULT_BAND_HALO,
# FAULT_STALE_SLOT)
FAULTS = {"halo row from the neighbouring band": 1, "stale ring slot": 2}


class K3Plan(NamedTuple):
    """How one launch of the stream instance runs (csrc/depthwise.cu)."""

    tw: int              # output columns of a strip (a block's columns)
    cv: int              # 16-byte channel vectors of a chunk: 8 cv channels
    bh: int              # output rows of a band
    ring: int            # ring slots of input rows; ring - 1 rows in flight
    per_chunk: int       # blocks a chunk; each takes items first, first + per_chunk, ...
    strips: int          # ceil(W / tw)
    bands: int           # ceil(H / bh)
    chunks: int          # ceil(C / (8 cv))
    items: int           # (image, band, strip) items of a chunk: B bands strips
    grid: int            # blocks: chunks x per_chunk
    threads: int
    smem: int            # dynamic shared memory of a block in bytes: ring and bias

    @property
    def lcv(self) -> int:
        return self.cv.bit_length() - 1


def depthwise_conv2d_reference(x: torch.Tensor, kernel: torch.Tensor,
                               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K3 (same arguments as the kernel wrapper):
    the k x k taps summed in float32 in (dy, dx) order over the zero-padded
    input, as ``depthwise.py:29-50`` does, then the bias in float32; returns
    [B, H, W, C] in ``x.dtype``."""
    k = kernel.shape[0]
    p = (k - 1) // 2
    _, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    kern = kernel.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :] * kern[dy, dx]
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def _check_kernel_args(x, kernel, bias):
    """The kernel's argument checks; every error names the module path."""
    def fail(msg):
        raise ValueError(f"{msg}; use_kernels=False runs such a model on its module path")

    if x.dim() != 4:
        fail(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        fail(f"the K3 kernel takes torch.bfloat16 or torch.float32, not {x.dtype}")
    if not x.is_contiguous():
        fail("x must be contiguous [B, H, W, C] (channels last)")
    if kernel.dim() != 3 or kernel.shape[0] != kernel.shape[1] or kernel.shape[2] != c:
        fail(f"kernel must be [k, k, {c}], got {tuple(kernel.shape)}")
    k = kernel.shape[0]
    if k not in KERNEL_SIZES:
        fail(f"the K3 kernel takes k in {KERNEL_SIZES}, not {k}")
    for name, t in (("kernel", kernel), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != x.dtype:
            fail(f"{name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            fail(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            fail(f"{name} must be contiguous")
    if bias is not None and tuple(bias.shape) != (c,):
        fail(f"bias must be [{c}], got {tuple(bias.shape)}")
    if b >= 65536:
        fail(f"batch {b} is beyond the K3 grid")
    return b, h, w, c, k


def instance(x: torch.Tensor, kernel: torch.Tensor) -> str:
    """The instance a launch on these (checked) operands runs: ``"stream"``
    for bf16 x with k = 3, C a multiple of 8 and 16-byte aligned data
    pointers of x and the kernel (the stream instance copies, loads and
    stores 16-byte channel vectors; it reads the bias element by element);
    ``"general"`` otherwise."""
    if (x.dtype == torch.bfloat16 and kernel.shape[0] == 3 and x.shape[3] % 8 == 0
            and (x.data_ptr() | kernel.data_ptr()) % 16 == 0):
        return "stream"
    return "general"


def layout(b: int, h: int, w: int, c: int, lcv: int, bh: int, ring: int,
           per_chunk: Optional[int] = None) -> K3Plan:
    """The stream launch for [b, h, w, c] with chunks of 2^lcv vectors, bands
    of ``bh`` rows and ``ring`` slots (``stream_geometry`` in the source).
    ``per_chunk`` defaults to as many blocks a chunk as the SMs hold
    (BLOCKS_PER_SM each), at most one an item."""
    cv, tw = 1 << lcv, STREAM_THREADS >> lcv
    strips, bands, chunks = -(-w // tw), -(-h // bh), -(-c // (8 * cv))
    items = b * bands * strips
    if per_chunk is None:
        per_chunk = min(items, max(1, SMS * BLOCKS_PER_SM // chunks))
    return K3Plan(tw, cv, bh, ring, per_chunk, strips, bands, chunks, items, chunks * per_chunk,
                  STREAM_THREADS, ring * (tw + 2) * cv * 16 + cv * 8 * 4)


def stream_rows(p: K3Plan) -> int:
    """Input rows the busiest block of ``p`` streams: bh + 2 an item."""
    return -(-p.items // p.per_chunk) * (p.bh + 2)


def cost(p: K3Plan) -> float:
    """plan()'s estimate of a launch's time, in 16-byte vectors moved: the
    longer of the busiest block's stream (BLOCK_ROW_COST a row, once a wave
    of resident blocks) and an SM's share of all the rows, each row's read
    (TW + 2 columns) and written (TW) vectors."""
    waves = -(-p.grid // (SMS * BLOCKS_PER_SM))
    rows = p.chunks * p.items * (p.bh + 2)
    return max(BLOCK_ROW_COST * stream_rows(p) * waves, rows / SMS) * (2 * p.tw + 2) * p.cv


def _ring(p: K3Plan) -> int:
    """The fewest ring slots whose rows in flight, over the blocks an SM
    holds, reach INFLIGHT_BYTES, but no more rows in flight than a quarter
    of the block's stream (at least two)."""
    per_sm = min(BLOCKS_PER_SM, -(-p.grid // SMS))
    slot = (p.tw + 2) * p.cv * 16
    cap = max(2, stream_rows(p) // 4)
    fits = [ring for ring in RINGS if ring - 1 <= cap] or [RINGS[0]]
    for ring in fits:
        if (ring - 1) * slot * per_sm >= INFLIGHT_BYTES:
            return ring
    return fits[-1]


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, w: int, c: int) -> K3Plan:
    """The stream launch for bf16 [b, h, w, c] (C a multiple of 8). Among the
    strip widths TW of 32, 16 and 8 columns (chunks of 4, 8 and 16 vectors)
    no wider than the image (8 always) and every distinct band height
    ceil(H / n), whose grids have at least min(SMS, the most blocks any band
    height gives) blocks, the least :func:`cost`; ties go to taller bands,
    then wider strips. The ring is :func:`_ring`'s."""
    if min(b, h, w, c) < 1 or c % 8:
        raise ValueError(f"no stream plan for [{b}, {h}, {w}, {c}]")
    best = None
    for lcv in LCVS:
        if STREAM_THREADS >> lcv > max(w, 8):
            continue
        fill = min(SMS, layout(b, h, w, c, lcv, 1, RINGS[-1]).grid)
        for bh in sorted({-(-h // n) for n in range(1, h + 1)}):
            p = layout(b, h, w, c, lcv, bh, RINGS[-1])
            if p.grid < fill:
                continue
            key = (cost(p), -bh, lcv)
            if best is None or key < best[0]:
                best = (key, p)
    p = best[1]
    return layout(b, h, w, c, p.lcv, p.bh, _ring(p))


def _lib():
    lib = build.library("depthwise")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.depthwise_stream.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.depthwise_stream.restype = i
        lib.depthwise_stream_fault.argtypes = [p] * 4 + [i] * 9 + [p]
        lib.depthwise_stream_fault.restype = i
        lib.depthwise_general.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.depthwise_general.restype = i
        lib.depthwise_geometry.argtypes = [i] * 8 + [ctypes.POINTER(ctypes.c_int)]
        lib.depthwise_geometry.restype = None
        lib.depthwise_stream_occupancy.argtypes = [i] * 2
        lib.depthwise_stream_occupancy.restype = i
        lib._typed = True
    return lib


def _run(entry: str, x, kernel, bias, *ints: int) -> torch.Tensor:
    """One launch of the source's C entry ``entry`` on checked CUDA operands;
    ``ints`` are the entry's own after the pointers. Enters x's device only
    when it is not the current one."""
    out = torch.empty_like(x)
    args = (x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), *ints)
    fn = getattr(_lib(), entry)
    index = x.device.index
    # the current stream's handle without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return out


def _stream_ints(b, h, w, c, p: K3Plan):
    return (b, h, w, c, p.lcv, p.bh, p.ring, p.per_chunk)


@functools.lru_cache(maxsize=256)
def _served_ints(b: int, h: int, w: int, c: int):
    """The stream entry's ints for :func:`plan`'s launch of [b, h, w, c]."""
    return _stream_ints(b, h, w, c, plan(b, h, w, c))


def source_geometry(b: int, h: int, w: int, c: int, lcv: int, bh: int, ring: int,
                    per_chunk: int) -> Tuple[int, ...]:
    """The source's own numbers for a stream launch: (grid, threads, shared
    memory, strips, bands, chunks, items), as :class:`K3Plan` has them."""
    out = (ctypes.c_int * 7)()
    _lib().depthwise_geometry(b, h, w, c, lcv, bh, ring, per_chunk, out)
    return tuple(out)


def source_occupancy(ring: int, smem: int) -> int:
    """Blocks of the stream instance one SM holds (the CUDA runtime's
    occupancy of the built kernel)."""
    return _lib().depthwise_stream_occupancy(ring, smem)


def run_stream(x, kernel, bias, p: K3Plan) -> torch.Tensor:
    """The stream instance launched as ``p`` lays it out (any layout of the
    same shape, for the card tests and the probe's sweep). Not counted in
    LAUNCHES."""
    b, h, w, c, _ = _check_kernel_args(x, kernel, bias)
    if instance(x, kernel) != "stream":
        raise ValueError("the stream instance takes bf16, k = 3, C % 8 == 0, aligned x and kernel")
    return _run("depthwise_stream", x, kernel, bias, *_stream_ints(b, h, w, c, p))


def planted_fault(fault: str, x, kernel, bias=None, p: Optional[K3Plan] = None) -> torch.Tensor:
    """The stream instance with a planted fault of :data:`FAULTS`, laid out
    as ``p`` (default :func:`plan`'s), for the card checks (the source's
    ``depthwise_stream_fault``, a template flag). Not counted in LAUNCHES."""
    b, h, w, c, _ = _check_kernel_args(x, kernel, bias)
    if instance(x, kernel) != "stream":
        raise ValueError("the planted faults run only the stream instance")
    p = plan(b, h, w, c) if p is None else p
    return _run("depthwise_stream_fault", x, kernel, bias, *_stream_ints(b, h, w, c, p),
                FAULTS[fault])


def depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME stride-1 depthwise conv of x [B, H, W, C] with kernel [k, k, C]
    and bias [C] or None; returns [B, H, W, C] in ``x.dtype``.

    CUDA tensors run the kernel's instance that :func:`instance` names (bf16
    or float32, k 3, 5 or 7; anything the kernel does not take raises), the
    stream instance as :func:`plan` lays it out. CPU tensors run the
    reference.
    """
    refuse_export("K3 (depthwise_conv2d)", x)
    if x.device.type == "cpu":
        return depthwise_conv2d_reference(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv2d runs on cuda or cpu, not {x.device}")
    b, h, w, c, k = _check_kernel_args(x, kernel, bias)
    if instance(x, kernel) == "stream":
        out = _run("depthwise_stream", x, kernel, bias, *_served_ints(b, h, w, c))
        LAUNCHES["depthwise_conv2d_stream"] += 1
    else:
        out = _run("depthwise_general", x, kernel, bias, b, h, w, c, k,
                   int(x.dtype == torch.float32))
        LAUNCHES["depthwise_conv2d_general"] += 1
    LAUNCHES["depthwise_conv2d"] += 1
    return out
