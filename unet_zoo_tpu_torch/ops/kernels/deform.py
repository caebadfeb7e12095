"""K8: modulated deformable convolution (DCNv2, one offset group), fused.

For each output pixel n and tap k of the kh x kw kernel, the sample position
(clamped to a 1-pixel zero frame, as ``ops/deform.py::sample_positions``),
then

    g[n, k, :] = round(sum_q x_pad[corner_q(n, k), :] * cw_q(n, k))   (f32 sums)
    out[n, :]  = round(sum_k g[n, k, :] @ W[k] + bias)                (f32 sums)

with cw the four bilinear corner weights times the modulation mask, in
float32, and ``round`` to x's type, once each. Counterpart of
``unet_zoo_tpu/ops/pallas/deform.py::deform_conv2d_pallas``; the positions
and weights are computed inside the kernel, where the Pallas version
precomputes them in XLA.

On a CUDA tensor :func:`deform_conv2d` launches the hand-written Hopper kernel
in ``csrc/deform.cu`` (one persistent grid, laid out by :func:`plan`: each
warp owns a 2-D patch of 16 output pixels and walks its taps on its own, W
resident in shared memory where it fits, each sample formed once, one warp's
products overlapping the other warps' gathers); on a CPU tensor it runs
:func:`deform_conv2d_reference`, the plain PyTorch version. Layouts are the
JAX package's: x [B, H, W, C], offset [B, Ho, Wo, 2K] with (dy, dx) pairs
per tap, mask [B, Ho, Wo, K], weight [kh, kw, C, O].
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from unet_zoo_tpu_torch.ops.deform import gather_corners, out_size, padded_rows, sample_positions
from unet_zoo_tpu_torch.ops.kernels import build, refuse_export

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"deform_conv2d": 0}

PATCH = 16               # output pixels a warp owns (csrc/deform.cu): one m16 row tile
CK_MAX = 128             # channels of one chunk of the gathered row tile
MAX_CHANNELS = 8192      # C: the zero row that corners outside the image read
SAMPLE_BYTES = 48        # a formed sample in shared memory
MAX_OUT_CHANNELS = 128   # O: 16 n-tiles of the block's accumulator
MAX_TAPS = 49
SMEM_LIMIT = 232448      # an H100 block's dynamic shared memory


def deform_conv2d_reference(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                            stride: int = 1, padding: int = 1, dilation: int = 1
                            ) -> torch.Tensor:
    """Plain PyTorch version of K8 (same arguments as the kernel wrapper):
    corner weights in float32, each tap's blended row (the four corners
    added in order) rounded to x's type once, the tap products summed in
    float32, then the bias, as ``deform.py:40-65`` does; returns [B, Ho, Wo,
    O] in ``x.dtype``."""
    b, h, w, c = x.shape
    kh, kw, _, o = weight.shape
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    s = sample_positions(h, w, offset, mask, kh, kw, stride, padding, dilation)
    rows = padded_rows(x)
    wk = weight.to(x.dtype).float().reshape(kh * kw, c, o)
    out = torch.zeros(b, ho * wo, o, dtype=torch.float32, device=x.device)
    for ki in range(kh * kw):
        p = gather_corners(rows, s.idx[..., ki], w + 2).float() * s.cw[:, :, ki, :, None]
        g = (((p[:, :, 0] + p[:, :, 1]) + p[:, :, 2]) + p[:, :, 3]).to(x.dtype)
        out = out + g.float() @ wk[ki]
    if bias is not None:
        out = out + bias.float()
    return out.reshape(b, ho, wo, o).to(x.dtype)


class DeformPlan(NamedTuple):
    """How one K8 launch runs (csrc/deform.cu)."""

    th: int          # a warp's patch: th output rows ...
    tw: int          # ... x tw output columns (th * tw = PATCH)
    wy: int          # the block tile: wy patches down ...
    wx: int          # ... x wx patches across (wy * wx = warps)
    warps: int       # warps of a block: 16, or 8 at O > 64
    nt: int          # 8-column MMA tiles of the accumulator: O rounded up to 32, 64 or 128
    ck: int          # channels of a chunk: C rounded up to 16, at most CK_MAX
    nch: int         # channel chunks: ceil(C / ck)
    group: int       # taps whose weight slots share memory at once (all: W resident)
    resident: bool   # group == K: W loaded once per block, no barrier in the tap loop
    smem: int        # a block's dynamic shared memory in bytes
    tiles: int       # block tiles: B * ceil(Ho / (wy th)) * ceil(Wo / (wx tw))
    grid: int        # persistent blocks: one an SM, at most one a tile


def n_tiles(o: int) -> int:
    """8-column MMA tiles of the accumulator: O rounded up to 32, 64 or 128
    (``nt_of`` in csrc/deform.cu)."""
    return 4 if o <= 32 else 8 if o <= 64 else 16


def n_warps(nt: int) -> int:
    """Warps of a block (``warps_of`` in csrc/deform.cu)."""
    return 16 if nt <= 8 else 8


def smem_bytes(ck: int, nch: int, group: int, nt: int) -> int:
    """A block's shared memory (``smem_bytes`` in csrc/deform.cu): ``group``
    taps' weight slots ([ck, 8 nt + 8] bf16 a chunk) and, for each warp, its
    [16, ck + 8] bf16 row tile and 16 samples (four corner weights and four
    corner pointers, SAMPLE_BYTES each)."""
    return (group * nch * ck * (8 * nt + 8) * 2
            + n_warps(nt) * PATCH * ((ck + 8) * 2 + SAMPLE_BYTES))


def chunks(c: int) -> Tuple[int, int]:
    """(ck, nch): C rounded up to 16 and cut into chunks of at most CK_MAX
    channels (``fill_geometry`` in csrc/deform.cu)."""
    ck = min(-(-c // 16) * 16, CK_MAX)
    return ck, -(-c // ck)


def _pow2_at_least(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def default_patch(wo: int) -> Tuple[int, int]:
    """A 4 x 4 patch, or a narrower and taller one of 16 pixels where the
    output has fewer than 3 columns."""
    tw = min(4, _pow2_at_least(wo))
    return PATCH // tw, tw


def plan(b: int, c: int, o: int, taps: int, ho: int, wo: int, sms: int = 132) -> DeformPlan:
    """The launch of x [B, H, W, C] -> [B, Ho, Wo, O] with ``taps`` taps on a
    card of ``sms`` SMs: each warp a :func:`default_patch` of 16 pixels, a
    block tile of at most 4 patches across (as many as the output's width
    holds), W resident wherever every tap's slots fit beside the row tiles
    in SMEM_LIMIT, else in the largest group of taps that fits, one
    persistent block an SM."""
    th, tw = default_patch(wo)
    nt = n_tiles(o)
    warps = n_warps(nt)
    wx = min(4, warps, _pow2_at_least(-(-wo // tw)))
    wy = warps // wx
    ck, nch = chunks(c)
    if smem_bytes(ck, nch, 1, nt) > SMEM_LIMIT:
        raise ValueError(f"C={c}, O={o}: one tap's weights do not fit a K8 block")
    group = max(g for g in range(1, taps + 1) if smem_bytes(ck, nch, g, nt) <= SMEM_LIMIT)
    tiles = b * -(-ho // (wy * th)) * -(-wo // (wx * tw))
    return DeformPlan(th, tw, wy, wx, warps, nt, ck, nch, group, group == taps,
                      smem_bytes(ck, nch, group, nt), tiles, min(tiles, sms))


def _check_kernel_args(x, offset, mask, weight, bias, stride, padding, dilation):
    """The kernel's argument checks; every error names the module path."""
    def fail(msg):
        raise ValueError(f"{msg}; use_kernels=False runs such a model on its module path")

    if x.dim() != 4 or weight.dim() != 4:
        fail(f"x must be [B, H, W, C] and weight [kh, kw, C, O], got {tuple(x.shape)} and "
             f"{tuple(weight.shape)}")
    b, h, w, c = x.shape
    kh, kw, wc, o = weight.shape
    if wc != c:
        fail(f"weight takes {wc} channels, x has {c}")
    if min(stride, dilation) < 1 or padding < 0:
        fail(f"stride {stride}, padding {padding}, dilation {dilation}")
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    k = kh * kw
    if ho < 1 or wo < 1:
        fail(f"no output pixels for a {h}x{w} image")
    for name, t, shape in (("offset", offset, (b, ho, wo, 2 * k)), ("mask", mask, (b, ho, wo, k)),
                           ("weight", weight, None), ("x", x, None)):
        if shape is not None and tuple(t.shape) != shape:
            fail(f"{name} is {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.bfloat16:
            fail(f"the K8 kernel takes torch.bfloat16, {name} is {t.dtype}")
        if t.device != x.device:
            fail(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            fail(f"{name} must be contiguous (channels last)")
    if bias is not None and (tuple(bias.shape) != (o,) or bias.device != x.device):
        fail(f"bias must be [{o}] on {x.device}, got {tuple(bias.shape)} on {bias.device}")
    if c > MAX_CHANNELS:
        fail(f"the K8 kernel takes up to {MAX_CHANNELS} input channels, not {c}")
    if not 1 <= o <= MAX_OUT_CHANNELS:
        fail(f"the K8 kernel takes up to {MAX_OUT_CHANNELS} output channels, not {o}")
    if k > MAX_TAPS:
        fail(f"the K8 kernel takes up to {MAX_TAPS} taps, not {k}")
    if smem_bytes(*chunks(c), 1, n_tiles(o)) > SMEM_LIMIT:
        fail(f"C={c}, O={o}: one tap's weights do not fit the K8 kernel's shared memory")
    if b * ho * wo * 2 * k >= 2**31 or x.numel() >= 2**31:
        fail("more than 2^31 samples or elements of x")
    return b, h, w, c, ho, wo, o, kh, kw


def _lib():
    lib = build.library("deform")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.deform_conv.argtypes = [p] * 6 + [i] * 18 + [p]
        lib.deform_conv.restype = i
        lib.deform_conv_fault.argtypes = [p] * 6 + [i] * 18 + [p]
        lib.deform_conv_fault.restype = i
        lib.deform_geometry.argtypes = [i] * 14 + [ctypes.POINTER(ctypes.c_int)]
        lib.deform_geometry.restype = None
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def source_geometry(b, h, w, c, o, kh, kw, ho, wo, p: DeformPlan) -> Tuple[int, ...]:
    """The source's own numbers for plan ``p``: (tiles, ck, nch, warps,
    weight slot pitch, shared memory bytes)."""
    out = (ctypes.c_int * 6)()
    _lib().deform_geometry(b, h, w, c, ho, wo, o, kh, kw, p.th, p.tw, p.wy, p.wx, p.group, out)
    return tuple(out)


def _run(x, offset, mask, weight, bias, stride, padding, dilation,
         fault: bool = False) -> torch.Tensor:
    """One K8 call on CUDA tensors (checked here), laid out by :func:`plan`;
    with ``fault`` the source's ``deform_conv_fault`` instead."""
    b, h, w, c, ho, wo, o, kh, kw = _check_kernel_args(x, offset, mask, weight, bias, stride,
                                                       padding, dilation)
    p = plan(b, c, o, kh * kw, ho, wo, _sms(x.device.index or 0))
    lib = _lib()
    bias32 = None if bias is None else bias.float().contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = torch.empty((b, ho, wo, o), dtype=x.dtype, device=x.device)
        entry = lib.deform_conv_fault if fault else lib.deform_conv
        err = entry(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                    None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
                    b, h, w, c, ho, wo, o, kh, kw, stride, padding, dilation, p.th, p.tw, p.wy,
                    p.wx, p.group, p.grid, stream)
        if err:
            raise RuntimeError(f"deform_conv launch failed: cudaError {err}")
    return out


def planted_fault(x, offset, mask, weight, bias=None, stride=1, padding=1,
                  dilation=1) -> torch.Tensor:
    """A planted fault for the card checks: the kernel with each tap's row
    tile multiplied by the next tap's weights (the source's
    ``deform_conv_fault``, a template flag). Not counted in LAUNCHES."""
    return _run(x, offset, mask, weight, bias, stride, padding, dilation, fault=True)


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride: int = 1,
                  padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Modulated deformable conv of x [B, H, W, C]: offset [B, Ho, Wo, 2K],
    mask [B, Ho, Wo, K], weight [kh, kw, C, O], bias [O] or None; returns
    [B, Ho, Wo, O] in ``x.dtype``.

    CUDA tensors run the kernel (bfloat16 x, offset, mask and weight, all
    contiguous; anything the kernel does not take raises); CPU tensors run
    the reference.
    """
    refuse_export("K8 (deform_conv2d)", x)
    if x.device.type == "cpu":
        return deform_conv2d_reference(x, offset, mask, weight, bias, stride, padding, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d runs on cuda or cpu, not {x.device}")
    out = _run(x, offset, mask, weight, bias, stride, padding, dilation)
    LAUNCHES["deform_conv2d"] += 1
    return out
