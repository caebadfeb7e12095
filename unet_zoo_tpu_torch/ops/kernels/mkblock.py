"""K4: mmunet's MKBlock in eval, fused.

    a = gelu(s1 * dw3(x1) + t1); b = gelu(s2 * dw5(a + x2) + t2)
    c = gelu(s3 * dw7(b + x3) + t3); h0 = bf16([a | b | c | x4])
    out = x + bf16(gelu(h0 @ w1 + b1)) @ w2 + b2

Counterpart of ``unet_zoo_tpu/ops/pallas/mkblock.py::fused_mkblock`` with
``fold_mkblock_params``. On a CUDA tensor :func:`fused_mkblock` launches the
hand-written Hopper kernel in ``csrc/mkblock.cu`` (three grids: the
depthwise cascade into a bf16 ``h0``, then the two GEMMs of the pointwise
MLP); on a CPU tensor it runs :func:`fused_mkblock_reference`, the plain
PyTorch version. Activations are logical NCHW in ``channels_last`` memory.

Both round ``h0`` and the hidden layer to bfloat16 before each product, as
the TPU kernel does (``mkblock.py:127,141`` there).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"fused_mkblock": 0}

# Channel counts the kernel takes: each quarter holds whole 8-channel
# (16-byte) chunks.
CHANNEL_ALIGN = 32
_KERNELS = (3, 5, 7)     # the cascade's depthwise kernel sizes
_NTAPS = 9 + 25 + 49


class MKBlockWeights(NamedTuple):
    """An eval-mode MKBlock folded into the kernel's operands."""

    taps: torch.Tensor    # [83, q] f32: dw3, dw5, dw7 taps, row-major per kernel
    affine: torch.Tensor  # [6, q] f32: (s1, t1, s2, t2, s3, t3)
    w1: torch.Tensor      # [C, 4C] bf16: pwconv1 with norm4's scale folded in
    b1: torch.Tensor      # [4C] f32: pwconv1 bias with norm4's shift folded in
    w2: torch.Tensor      # [4C, C] bf16: pwconv2
    b2: torch.Tensor      # [C] f32


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


def _check_kernel_args(x, taps, affine, w1, b1, w2, b2):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % CHANNEL_ALIGN:
        raise ValueError(f"C={c} must be a multiple of {CHANNEL_ALIGN}")
    q = c // 4
    want = {"taps": (_NTAPS, q), "affine": (6, q), "w1": (c, 4 * c), "b1": (4 * c,),
            "w2": (4 * c, c), "b2": (c,)}
    for name, t, dt in (("x", x, torch.bfloat16), ("taps", taps, torch.float32),
                        ("affine", affine, torch.float32), ("w1", w1, torch.bfloat16),
                        ("b1", b1, torch.float32), ("w2", w2, torch.bfloat16),
                        ("b2", b2, torch.float32)):
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want[name]} for C={c}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if name != "x" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("x must be channels_last contiguous and 16-byte aligned")
    if b * h * w >= 2**31:
        raise ValueError("B*H*W must stay below 2^31: the kernel's row index is an int")
    return b, c, h, w


def _lib():
    lib = build.library("mkblock")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mkblock_forward.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.mkblock_forward.restype = i
        lib.mkblock_needs_hidden.argtypes = [i]
        lib.mkblock_needs_hidden.restype = i
        lib._typed = True
    return lib


def fused_mkblock(x, taps, affine, w1, b1, w2, b2):
    """The MKBlock base in eval: x [B, C, H, W] channels_last; the rest as
    :func:`fold_mkblock_params` returns them. Returns [B, C, H, W]
    channels_last in ``x.dtype``.

    CUDA tensors run the kernel (bf16 x and w1/w2, float32 taps, affine and
    biases; anything else raises); CPU tensors run the reference.
    """
    if x.device.type == "cpu":
        return fused_mkblock_reference(x, taps, affine, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mkblock runs on cuda or cpu, not {x.device}")
    b, c, h, w = _check_kernel_args(x, taps, affine, w1, b1, w2, b2)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        h0 = torch.empty_like(x, memory_format=torch.channels_last)
        # the [B*H*W, 4C] hidden layer passes through device memory only where
        # the kernel runs its MLP as two GEMM grids
        hid = (torch.empty((b * h * w, 4 * c), dtype=torch.bfloat16, device=x.device)
               if lib.mkblock_needs_hidden(c) else None)
        out = torch.empty_like(x, memory_format=torch.channels_last)
        err = lib.mkblock_forward(x.data_ptr(), taps.data_ptr(), affine.data_ptr(),
                                  w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                  h0.data_ptr(), None if hid is None else hid.data_ptr(),
                                  out.data_ptr(),
                                  b, h, w, c, stream)
        if err:
            raise RuntimeError(f"mkblock_forward launch failed: cudaError {err}")
    LAUNCHES["fused_mkblock"] += 1
    return out
