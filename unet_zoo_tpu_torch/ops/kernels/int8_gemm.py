"""P2: the int8 GEMM and the int8 3x3 conv as an implicit GEMM, on the tensor cores.

Counterpart of the root probe ``_probe_int8_mosaic.py::make_matmul`` (a tiled
``A[M, K] . B[K, N]``, s8 x s8 -> s32 or bf16 x bf16 -> f32) and the carrier
of the JAX package's int8 serving conv (``nn/blocks.py::_QuantConv``, whose
s8 x s8 -> s32 ``lax.conv`` XLA lowered). One source, ``csrc/int8_gemm.cu``,
two entry points over one tile loop:

* :func:`matmul`: ``out[M, N] = a[M, K] . bt[N, K]^T``, int8 -> int32 or
  bf16 -> float32; both operands K-contiguous.
* :func:`int8_conv3x3`: NHWC int8 ``xq`` [B, H, W, Ci] with the weights
  packed by :func:`pack_conv_weight` ([Co, Kpad] int8, K = 9 Ci in (ky, kx,
  ci) order, zero-padded to a multiple of 64), stride 1 or 2, padding 1; the
  exact int32 sums dequantised as ``rn(rn(acc * scale) + bias)`` in float32
  and rounded once to ``out_dtype`` (float32 or bfloat16): bit for bit what
  :func:`int8_conv3x3_reference` computes.

On a CUDA tensor each wrapper launches the kernel (or raises for what it does
not take, naming ``use_kernels=False``); on a CPU tensor it runs the plain
PyTorch version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops import quant
from unet_zoo_tpu_torch.ops.kernels import build

# Times each wrapper launched its CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"int8_conv3x3": 0, "matmul": 0}

K_ALIGN = 64  # bytes of K a pipeline stage takes (csrc/int8_gemm.cu BKB)


def pack_conv_weight(wq: torch.Tensor) -> torch.Tensor:
    """OIHW int8 3x3 weights -> [Co, Kpad] int8, K = (ky, kx, ci) flattened
    and zero-padded to a multiple of K_ALIGN."""
    co, ci = wq.shape[:2]
    k = 9 * ci
    kpad = -(-k // K_ALIGN) * K_ALIGN
    return F.pad(wq.permute(0, 2, 3, 1).reshape(co, k), (0, kpad - k)).contiguous()


def unpack_conv_weight(wp: torch.Tensor, ci: int) -> torch.Tensor:
    """The inverse of :func:`pack_conv_weight`: OIHW int8."""
    return wp[:, :9 * ci].reshape(-1, 3, 3, ci).permute(0, 3, 1, 2)


def conv_out_size(n: int, stride: int) -> int:
    """Output extent of a 3x3 conv with padding 1."""
    return (n - 1) // stride + 1


def int8_conv3x3_reference(xq: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                           bias: Optional[torch.Tensor], stride: int,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_conv3x3` (same arguments): the
    exact int32 sums (``quant.int8_conv2d_exact``, float64), dequantised by
    ``quant.dequantize``; returns [B, Ho, Wo, Co] in ``out_dtype``."""
    wq = unpack_conv_weight(wp, xq.shape[-1])
    acc = quant.int8_conv2d_exact(xq.permute(0, 3, 1, 2), wq, stride, 1)
    return quant.dequantize(acc.permute(0, 2, 3, 1), scale, bias, out_dtype, channel_dim=-1)


def matmul_reference(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`matmul`: int8 operands give the exact
    int32 product (float64 holds every partial sum below 2^53), bf16 operands
    the float32 product of their float32 values."""
    if a.dtype == torch.int8:
        return (a.double() @ bt.double().t()).to(torch.int32)
    return a.float() @ bt.float().t()


def _fail(msg):
    raise ValueError(f"{msg}; use_kernels=False runs the int8 conv on its plain version")


def _check_conv_args(xq, wp, scale, bias, stride, out_dtype):
    if xq.dim() != 4 or xq.dtype != torch.int8:
        _fail(f"xq must be int8 [B, H, W, Ci], got {xq.dtype} {tuple(xq.shape)}")
    if not xq.is_contiguous():
        _fail("xq must be contiguous [B, H, W, Ci] (channels last)")
    b, h, w, ci = xq.shape
    kpad = -(-9 * ci // K_ALIGN) * K_ALIGN
    if wp.dtype != torch.int8 or wp.dim() != 2 or wp.shape[1] != kpad or not wp.is_contiguous():
        _fail(f"wp must be contiguous int8 [Co, {kpad}] (pack_conv_weight), got {wp.dtype} "
              f"{tuple(wp.shape)}")
    co = wp.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (co,) or not t.is_contiguous():
            _fail(f"{name} must be contiguous float32 [{co}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("wp", wp), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != xq.device:
            _fail(f"{name} is on {t.device}, xq on {xq.device}")
    if stride not in (1, 2):
        _fail(f"the int8 conv kernel takes stride 1 or 2, not {stride}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        _fail(f"the int8 conv kernel writes float32 or bfloat16, not {out_dtype}")
    ho, wo = conv_out_size(h, stride), conv_out_size(w, stride)
    if b * ho * wo >= 2 ** 31 or b * h * w * ci >= 2 ** 31:
        _fail("the int8 conv's shape is beyond the kernel's int32 row indices")
    return b, h, w, ci, ho, wo, co, kpad


def _lib():
    lib = build.library("int8_gemm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_conv3x3.argtypes = [p] * 5 + [i] * 10 + [p]
        lib.int8_conv3x3.restype = i
        lib.gemm.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.gemm.restype = i
        lib._typed = True
    return lib


def int8_conv3x3(xq: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor], stride: int,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """3x3 int8 conv (padding 1) of NHWC ``xq`` with packed weights ``wp``,
    dequantised by ``scale`` (= s_x * s_w) and ``bias`` [Co] (float32);
    returns [B, Ho, Wo, Co] in ``out_dtype``."""
    if xq.device.type == "cpu":
        return int8_conv3x3_reference(xq, wp, scale, bias, stride, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv3x3 runs on cuda or cpu, not {xq.device}")
    b, h, w, ci, ho, wo, co, kpad = _check_conv_args(xq, wp, scale, bias, stride, out_dtype)
    lib = _lib()
    with torch.cuda.device(xq.device):
        out = torch.empty(b, ho, wo, co, device=xq.device, dtype=out_dtype)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.int8_conv3x3(xq.data_ptr(), wp.data_ptr(), scale.data_ptr(),
                               None if bias is None else bias.data_ptr(), out.data_ptr(),
                               b, h, w, ci, ho, wo, co, stride, kpad,
                               int(out_dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"int8_conv3x3 launch failed: cudaError {err}")
    LAUNCHES["int8_conv3x3"] += 1
    return out


GEMM_TILES = ((128, 128), (256, 64))


def matmul(a: torch.Tensor, bt: torch.Tensor, tile=(128, 128)) -> torch.Tensor:
    """``a[M, K] . bt[N, K]^T``: int8 -> int32, or bf16 -> float32. ``tile``
    is the kernel's block tile (BM, BN), one of GEMM_TILES."""
    if a.device.type == "cpu":
        return matmul_reference(a, bt)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, not {a.device}")
    if a.dtype not in (torch.int8, torch.bfloat16) or bt.dtype != a.dtype:
        _fail(f"matmul takes int8 or bfloat16 operands of one type, got {a.dtype}, {bt.dtype}")
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        _fail(f"a must be [M, K] and bt [N, K], got {tuple(a.shape)}, {tuple(bt.shape)}")
    if not (a.is_contiguous() and bt.is_contiguous()) or bt.device != a.device:
        _fail("a and bt must be contiguous, on one device")
    (m, k), n = a.shape, bt.shape[0]
    if tuple(tile) not in GEMM_TILES:
        _fail(f"the GEMM kernel's tiles are {GEMM_TILES}, not {tile}")
    if (k * a.element_size()) % 16:
        _fail(f"the GEMM kernel takes K * element size a multiple of 16 bytes, K = {k}")
    if m >= 2 ** 31 // 128 or n >= 2 ** 31 // 128 or m * k * a.element_size() >= 2 ** 31:
        _fail("the GEMM's shape is beyond the kernel's int32 indices")
    lib = _lib()
    int8 = a.dtype == torch.int8
    with torch.cuda.device(a.device):
        out = torch.empty(m, n, device=a.device, dtype=torch.int32 if int8 else torch.float32)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.gemm(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, int(int8),
                       tile[0], stream)
        if err:
            raise RuntimeError(f"gemm launch failed: cudaError {err}")
    LAUNCHES["matmul"] += 1
    return out
