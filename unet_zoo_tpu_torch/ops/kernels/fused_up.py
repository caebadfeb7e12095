"""K1: the fused UNet decoder stage.

    out = relu(scale * conv3x3(concat(convT2x2s2(y) + bt, skip)) + bias)

Counterpart of ``unet_zoo_tpu/ops/pallas/fused_up.py::fused_up_concat_conv``.
On a CUDA tensor :func:`fused_up_concat_conv` launches the hand-written
Hopper kernel in ``csrc/fused_up.cu``: two persistent wgmma grids fed by TMA,
the ConvT GEMM into a bf16 scratch ``up``, then the 3x3 conv as an implicit
GEMM over ``up | skip`` whose pixel operand is a 4-D TMA halo box of bh + 2
rows, one per 64-channel chunk and column shift dx, read for the three row
shifts dy by descriptor offsets (:func:`plan` lays both grids out). On a CPU
tensor it
runs :func:`fused_up_concat_conv_reference`, the plain PyTorch version.
Activations are logical NCHW in ``channels_last`` memory.

Weights go in packed: ``wt`` and ``wc`` as :func:`pack_convt_kernel` and
:func:`pack_conv3x3_kernel` make them (the JAX package's matmul forms), and
``packed``, their K-major transposes from :func:`pack_kernel_weights`, which
the kernel reads; a caller packs both once and reuses them (a call without
``packed`` transposes on the spot).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build

# Times the wrapper launched the CUDA kernel pair (read by chip_smoke.py).
LAUNCHES = {"fused_up_concat_conv": 0}

_CHANNEL_ALIGN = 32  # the kernel's channel unit; a 64-channel chunk may pass the end
BM = 128             # the ConvT's tile rows: two consumer warpgroups of 64 (csrc/fused_up.cu)
CONVT_BN = 128       # the ConvT's tile columns (4 Cu is a multiple of 128)
BW = 16              # the conv's tile width in fine pixels
KC = 64              # channels of a K chunk: one 128-byte swizzled box row
SMS = 132            # an H100's SMs
SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory; SMEM_HALF where two share an SM
SMEM_HALF = 114688
EPI_LD = 72          # a staged epilogue row: 64 bf16 and 16 bytes of pad
MAX_STAGES = 6
# The grids the source instantiates: (mode 0 ConvT or 1 conv, bn, blocks an SM).
SOURCE_TILES = ((0, 128, 1), (0, 128, 2), (1, 128, 1), (1, 64, 1))
# The planted faults of the source's test-only entry ``fused_up_fault``.
FAULTS = {"halo one pixel short": 1, "dx and dy swapped": 2,
          "up|skip boundary off by one chunk": 3, "bt dropped": 4}


def pack_convt_kernel(wt: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d`` weight [Cin, Cu, 2, 2] -> [Cin, 4*Cu] matmul form.

    Columns are packed (a, b, cu)-major: column (a, b, cu) of coarse pixel
    (m, n) lands on fine pixel (2m+a, 2n+b). Torch applies the kernel
    unflipped (out[2m+a, 2n+b] = y[m, n] @ W[:, :, a, b]).
    """
    cin, cu, kh, kw = wt.shape
    return wt.permute(0, 2, 3, 1).reshape(cin, kh * kw * cu)


def pack_conv3x3_kernel(wc: torch.Tensor) -> torch.Tensor:
    """``Conv2d`` weight [Co, C, 3, 3] -> [9*C, Co], K in (dy, dx, c) order."""
    co, c, kh, kw = wc.shape
    return wc.permute(2, 3, 1, 0).reshape(kh * kw * c, co)


def pack_kernel_weights(wt: torch.Tensor, wc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K-major forms the kernel reads, from the packed ``wt`` [Cin, 4 Cu]
    and ``wc`` [9 C, Co]: ``wt_k`` [4 Cu, Cin] and ``wc_k`` [Co, 9 C], each
    row one output column's K (TMA boxes of 64 K values by a tile's rows)."""
    return wt.t().contiguous(), wc.t().contiguous()


def fold_conv_bn(conv_bias, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold conv bias + eval-mode BatchNorm into (scale, bias), in float32:
    BN(conv + b) == conv * scale + bias."""
    f = lambda t: t.float()
    scale = f(gamma) / torch.sqrt(f(var) + eps)
    bias = (f(conv_bias) - f(mean)) * scale + f(beta)
    return scale, bias


def convt_reference(y, wt, bt):
    """The ConvT half of the plain version: convT2x2s2(y) + bt accumulated in
    float32 and rounded to y's dtype (the kernel's ``up``)."""
    cin, cu4 = wt.shape
    cu = cu4 // 4
    wt4 = wt.float().reshape(cin, 2, 2, cu).permute(0, 3, 1, 2)
    return F.conv_transpose2d(y.float(), wt4, bt.float(), stride=2).to(y.dtype)


def conv_reference(up, skip, wc, scale, bias):
    """The conv half of the plain version on a given ``up``: float32 sums,
    rounded to ``skip.dtype``, channels_last."""
    c2, co = wc.shape[0] // 9, wc.shape[1]
    wc4 = wc.float().reshape(3, 3, c2, co).permute(3, 2, 0, 1)
    z = torch.cat([up, skip], dim=1).float()
    out = F.conv2d(z, wc4, padding=1)
    out = torch.relu(out * scale.float().view(1, -1, 1, 1)
                     + bias.float().view(1, -1, 1, 1))
    return out.to(skip.dtype).contiguous(memory_format=torch.channels_last)


def fused_up_concat_conv_reference(y, skip, wt, bt, wc, scale, bias):
    """Plain PyTorch version of K1 (same arguments as the kernel wrapper).

    Accumulates in float32 and rounds the upsampled intermediate to the
    input dtype, as the kernel does. Returns ``skip.dtype``, channels_last.
    """
    return conv_reference(convt_reference(y, wt, bt), skip, wc, scale, bias)


def _check_kernel_args(y, skip, wt, bt, wc, scale, bias):
    b, cin, hc, wcs = y.shape
    b2, cs, hf, wf = skip.shape
    if b2 != b or hf != 2 * hc or wf != 2 * wcs:
        raise ValueError(f"skip {tuple(skip.shape)} is not 2x y {tuple(y.shape)}")
    if wt.dim() != 2 or wt.shape[0] != cin or wt.shape[1] % 4:
        raise ValueError(f"packed ConvT weight {tuple(wt.shape)} does not fit Cin={cin}")
    cu = wt.shape[1] // 4
    if wc.dim() != 2 or wc.shape[0] != 9 * (cu + cs):
        raise ValueError(f"packed conv weight {tuple(wc.shape)} is not [9*(Cu+Cs), Co]"
                         f" with Cu={cu}, Cs={cs}")
    co = wc.shape[1]
    if bt.shape != (cu,) or scale.shape != (co,) or bias.shape != (co,):
        raise ValueError("bt must be [Cu], scale and bias [Co]")
    for name, c in (("Cin", cin), ("Cu", cu), ("Cs", cs)):
        if c % _CHANNEL_ALIGN:
            raise ValueError(f"{name}={c} must be a multiple of {_CHANNEL_ALIGN}")
    if co % 8:
        raise ValueError(f"Co={co} must be a multiple of 8")
    for name, t, dt in (("y", y, torch.bfloat16), ("skip", skip, torch.bfloat16),
                        ("wt", wt, torch.bfloat16), ("wc", wc, torch.bfloat16),
                        ("bt", bt, torch.float32), ("scale", scale, torch.float32),
                        ("bias", bias, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
    for name, t in (("y", y), ("skip", skip)):
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be channels_last contiguous")
    for name, t in (("wt", wt), ("bt", bt), ("wc", wc), ("scale", scale),
                    ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if y.numel() >= 2**31 or skip.numel() >= 2**31 or b * hf * wf * co >= 2**31:
        raise ValueError("tensors above 2^31 elements are not supported")
    return b, cin, hc, wcs, cu, cs, co


class FusedUpPlan(NamedTuple):
    """How one K1 call runs (csrc/fused_up.cu): two persistent grids."""

    bn: int          # the conv's tile width in Co (64 or 128)
    bm: int          # the conv's tile: bh x BW fine pixels of one image (bh BW = bm)
    bh: int
    th: int          # conv tiles along H, W and Co
    tw: int
    nt: int
    conv_tiles: int
    chunks_u: int    # 64-channel K chunks of up, then of skip
    chunks_s: int
    convt_ctas: int  # the ConvT's blocks an SM
    convt_nt: int    # ConvT tiles along N (4 Cu) and in all
    convt_tiles: int
    grid_convt: int  # persistent blocks of each grid
    grid_conv: int


@functools.lru_cache(maxsize=256)
def plan(b: int, hc: int, wc: int, cin: int, cu: int, cs: int, co: int,
         sms: int = SMS) -> FusedUpPlan:
    """The tiles of both grids. The conv takes 128 channels by 8 x 16 fine
    pixels, or for Co <= 64 64 channels by 16 x 16 in the transposed form
    (the channels as wgmma's M); its halo box reads each input pixel 3 (bh +
    2) / bh times. The ConvT's tile is 128 coarse pixels by 128 columns,
    two blocks an SM where Cin <= 256 (its short K leaves the epilogue a
    large share). One block an SM (two for such a ConvT) walks the tiles
    round-robin, Co fastest."""
    bn = 64 if co <= 64 else 128
    bm = 256 if bn == 64 else 128
    bh = bm // BW
    th, tw, nt = -(-2 * hc // bh), -(-2 * wc // BW), -(-co // bn)
    conv_tiles = b * th * tw * nt
    convt_ctas = 2 if cin <= 256 else 1
    convt_nt = 4 * cu // CONVT_BN
    convt_tiles = -(-(b * hc * wc) // BM) * convt_nt
    return FusedUpPlan(bn, bm, bh, th, tw, nt, conv_tiles, -(-cu // KC), -(-cs // KC),
                       convt_ctas, convt_nt, convt_tiles, min(convt_tiles, sms * convt_ctas),
                       min(conv_tiles, sms))


def ring(mode: int, bn: int, ctas: int) -> Tuple[int, int, int, int]:
    """A grid's ring of shared-memory stages (``Geometry`` in the source):
    (stages, bytes a stage, A bytes a stage, dynamic shared memory). A
    stage is a box of 64 channels (the conv's: bh + 2 rows of BW pixels;
    the ConvT's: 128 rows) and the weight tiles of its taps; each of the
    two consumer warpgroups stages its epilogue in a tile of its pix rows
    (the conv's transposed form, bn 64: 128)."""
    pix = 128 if mode and bn == 64 else 64
    bm = 2 * pix
    a = ((bm // BW + 2) * BW if mode else bm) * 2 * KC
    stage = a + (3 if mode else 1) * bn * 2 * KC
    epi = 2 * pix * EPI_LD * 2
    budget = SMEM_LIMIT if ctas == 1 else SMEM_HALF
    stages = min((budget - 1024 - epi) // (stage + 16), MAX_STAGES)
    return stages, stage, a, 1024 + stages * (stage + 16) + epi


def conv_tile(p: FusedUpPlan, tile: int) -> Tuple[int, int, int, int]:
    """(b, h0, w0, n0) of conv tile ``tile``, Co fastest (``tile_origin``)."""
    n0 = (tile % p.nt) * p.bn
    r = tile // p.nt
    w0 = (r % p.tw) * BW
    r //= p.tw
    return r // p.th, (r % p.th) * p.bh, w0, n0


def convt_tile(p: FusedUpPlan, tile: int) -> Tuple[int, int]:
    """(m0, n0) of ConvT tile ``tile``: 128 coarse pixels by 128 columns."""
    return (tile // p.convt_nt) * BM, (tile % p.convt_nt) * CONVT_BN


def conv_steps(p: FusedUpPlan, cu: int) -> List[Tuple[int, int, int, int]]:
    """The conv's K steps in order: (source, c0, k0, dx), source 0 up, 1
    skip; the step's box holds channels c0 .. c0 + 63 of its source (zeros
    past its end), and tap (dy, dx) reads weight rows (3 dy + dx) (Cu + Cs)
    + k0 onwards."""
    steps = []
    for chunk in range(p.chunks_u + p.chunks_s):
        src = int(chunk >= p.chunks_u)
        c0 = (chunk - src * p.chunks_u) * KC
        for dx in range(3):
            steps.append((src, c0, c0 + src * cu, dx))
    return steps


def halo_origin(b: int, h0: int, w0: int, c0: int, dx: int) -> Tuple[int, int, int, int]:
    """The 4-D box coordinate (c, w, h, b) of a step: its rows are input
    pixels (h0 - 1 + i, w0 + dx - 1 + j), i < bh + 2, j < BW; coordinates
    outside the image read zeros."""
    return c0, w0 + dx - 1, h0 - 1, b


def _lib():
    lib = build.library("fused_up")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_up_forward.argtypes = [p] * 9 + [i] * 11 + [p]
        lib.fused_up_forward.restype = i
        lib.fused_up_fault.argtypes = [i] + [p] * 9 + [i] * 11 + [p]
        lib.fused_up_fault.restype = i
        lib.fused_up_geometry.argtypes = [i] * 3 + [ctypes.POINTER(ctypes.c_int)]
        lib.fused_up_geometry.restype = None
        lib._typed = True
    return lib


def source_geometry(mode: int, bn: int, ctas: int) -> Tuple[int, int, int, int]:
    """The source's ring for a grid (mode 0 ConvT, 1 conv): (stages, bytes a
    stage, A bytes a stage, dynamic shared memory)."""
    out = (ctypes.c_int * 4)()
    _lib().fused_up_geometry(mode, bn, ctas, out)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_packed(packed, cin, cu, cs, co, device):
    wt_k, wc_k = packed
    for name, t, shape in (("wt_k", wt_k, (4 * cu, cin)), ("wc_k", wc_k, (co, 9 * (cu + cs)))):
        if tuple(t.shape) != shape or t.dtype != torch.bfloat16 or t.device != device \
                or not t.is_contiguous():
            raise ValueError(f"packed {name} must be a contiguous bf16 {list(shape)} on "
                             f"{device}, got {t.dtype} {list(t.shape)} on {t.device}")


def _run(y, skip, wt, bt, wc, scale, bias, packed, fault: int = 0
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K1 call on CUDA tensors (checked here), laid out by :func:`plan`;
    with ``fault`` the source's test-only ``fused_up_fault``. Returns the
    bf16 scratch ``up`` and the output."""
    b, cin, hc, wcs, cu, cs, co = _check_kernel_args(y, skip, wt, bt, wc, scale, bias)
    if packed is None:
        packed = pack_kernel_weights(wt, wc)
    _check_packed(packed, cin, cu, cs, co, y.device)
    wt_k, wc_k = packed
    for name, t in (("y", y), ("skip", skip), ("wt_k", wt_k), ("wc_k", wc_k)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (a TMA source)")
    p = plan(b, hc, wcs, cin, cu, cs, co, _sms(y.device.index or 0))
    lib = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        up = torch.empty((b, cu, 2 * hc, 2 * wcs), dtype=torch.bfloat16, device=y.device,
                         memory_format=torch.channels_last)
        out = torch.empty((b, co, 2 * hc, 2 * wcs), dtype=torch.bfloat16, device=y.device,
                          memory_format=torch.channels_last)
        args = (y.data_ptr(), wt_k.data_ptr(), bt.data_ptr(), skip.data_ptr(), wc_k.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), up.data_ptr(), out.data_ptr(),
                b, hc, wcs, cin, cu, cs, co, p.convt_ctas, p.grid_convt, p.bn, p.grid_conv,
                stream)
        err = lib.fused_up_fault(fault, *args) if fault else lib.fused_up_forward(*args)
        if err:
            raise RuntimeError(f"fused_up launch failed: error {err}")
    return up, out


def fused_up_concat_conv(y, skip, wt, bt, wc, scale, bias, packed=None):
    """relu(scale * conv3x3(concat(convT2x2s2(y) + bt, skip)) + bias).

    y: [B, Cin, Hc, Wc], skip: [B, Cs, 2Hc, 2Wc] (channels_last);
    wt: [Cin, 4*Cu] from :func:`pack_convt_kernel`; bt: [Cu];
    wc: [9*(Cu+Cs), Co] from :func:`pack_conv3x3_kernel` (up channels
    first); scale/bias: [Co], the folded conv bias and BatchNorm;
    packed: ``pack_kernel_weights(wt, wc)``, made once by the caller (or
    on the spot when None). Returns [B, Co, 2Hc, 2Wc] channels_last in
    ``skip.dtype``.

    CUDA tensors run the kernel (bf16 activations and weights, float32
    bt/scale/bias; anything else raises); CPU tensors run the reference.
    """
    if y.device.type == "cpu":
        return fused_up_concat_conv_reference(y, skip, wt, bt, wc, scale, bias)
    if y.device.type != "cuda":
        raise ValueError(f"fused_up_concat_conv runs on cuda or cpu, not {y.device}")
    out = _run(y, skip, wt, bt, wc, scale, bias, packed)[1]
    LAUNCHES["fused_up_concat_conv"] += 1
    return out


def kernel_stages(y, skip, wt, bt, wc, scale, bias, packed=None, fault=None):
    """For the card checks: the kernel pair's bf16 intermediate ``up`` and
    its output, so that each grid can be held against its own half of the
    plain version (:func:`convt_reference`, :func:`conv_reference`).
    ``fault``, a key of :data:`FAULTS`, launches the source's test-only
    entry ``fused_up_fault`` (a template flag each). Not counted in
    LAUNCHES."""
    return _run(y, skip, wt, bt, wc, scale, bias, packed, FAULTS[fault] if fault else 0)

