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
in ``csrc/deform.cu`` (one grid); on a CPU tensor it runs
:func:`deform_conv2d_reference`, the plain PyTorch version. Layouts are the
JAX package's: x [B, H, W, C], offset [B, Ho, Wo, 2K] with (dy, dx) pairs
per tap, mask [B, Ho, Wo, K], weight [kh, kw, C, O].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from unet_zoo_tpu_torch.ops.deform import gather_corners, out_size, padded_rows, sample_positions
from unet_zoo_tpu_torch.ops.kernels import build

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"deform_conv2d": 0}

_BM = 64                 # output pixels of one block (csrc/deform.cu)
MAX_OUT_CHANNELS = 128   # O: 16 n-tiles of the block's accumulator
MAX_TAPS = 49
_SMEM_LIMIT = 200 * 1024


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


def n_tiles(o: int) -> int:
    """8-column MMA tiles of the block's accumulator: O rounded up to 16, 32,
    64 or 128."""
    return max(2, 1 << (-(-o // 8) - 1).bit_length())


def smem_bytes(c: int, o: int) -> int:
    """Shared memory of one block (``smem_bytes`` in csrc/deform.cu)."""
    cpad = -(-c // 16) * 16
    return 2 * (_BM * (cpad + 8) + cpad * (8 * n_tiles(o) + 8))


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
    if not 1 <= o <= MAX_OUT_CHANNELS:
        fail(f"the K8 kernel takes up to {MAX_OUT_CHANNELS} output channels, not {o}")
    if k > MAX_TAPS:
        fail(f"the K8 kernel takes up to {MAX_TAPS} taps, not {k}")
    if smem_bytes(c, o) > _SMEM_LIMIT:
        fail(f"C={c}, O={o} does not fit the K8 kernel's shared memory")
    if b * ho * wo * 2 * k >= 2**31 or b * h * w >= 2**31:
        fail("more than 2^31 samples")
    return b, h, w, c, ho, wo, o, kh, kw


def _lib():
    lib = build.library("deform")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.deform_conv.argtypes = [p] * 6 + [i] * 12 + [p]
        lib.deform_conv.restype = i
        lib._typed = True
    return lib


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
    if x.device.type == "cpu":
        return deform_conv2d_reference(x, offset, mask, weight, bias, stride, padding, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d runs on cuda or cpu, not {x.device}")
    b, h, w, c, ho, wo, o, kh, kw = _check_kernel_args(x, offset, mask, weight, bias, stride,
                                                       padding, dilation)
    lib = _lib()
    bias32 = None if bias is None else bias.float().contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = torch.empty((b, ho, wo, o), dtype=x.dtype, device=x.device)
        err = lib.deform_conv(x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
                              None if bias32 is None else bias32.data_ptr(), out.data_ptr(),
                              b, h, w, c, ho, wo, o, kh, kw, stride, padding, dilation, stream)
        if err:
            raise RuntimeError(f"deform_conv launch failed: cudaError {err}")
    LAUNCHES["deform_conv2d"] += 1
    return out
