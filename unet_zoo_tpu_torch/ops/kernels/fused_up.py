"""K1: the fused UNet decoder stage.

    out = relu(scale * conv3x3(concat(convT2x2s2(y) + bt, skip)) + bias)

Counterpart of ``unet_zoo_tpu/ops/pallas/fused_up.py::fused_up_concat_conv``.
On a CUDA tensor :func:`fused_up_concat_conv` launches the hand-written
Hopper kernel in ``csrc/fused_up.cu`` (two launches: the ConvT GEMM into a
bf16 scratch ``up``, then the 3x3 implicit GEMM over ``up | skip``); on a
CPU tensor it runs :func:`fused_up_concat_conv_reference`, the plain
PyTorch version. Activations are logical NCHW in ``channels_last`` memory.

Weights go in packed, as the kernel reads them (see :func:`pack_convt_kernel`
and :func:`pack_conv3x3_kernel`), so a caller packs once and reuses them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build

# Times the wrapper launched the CUDA kernel pair (read by chip_smoke.py).
LAUNCHES = {"fused_up_concat_conv": 0}

_CHANNEL_ALIGN = 32  # a K chunk of the kernel never straddles a tap or up|skip


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


def fold_conv_bn(conv_bias, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold conv bias + eval-mode BatchNorm into (scale, bias), in float32:
    BN(conv + b) == conv * scale + bias."""
    f = lambda t: t.float()
    scale = f(gamma) / torch.sqrt(f(var) + eps)
    bias = (f(conv_bias) - f(mean)) * scale + f(beta)
    return scale, bias


def fused_up_concat_conv_reference(y, skip, wt, bt, wc, scale, bias):
    """Plain PyTorch version of K1 (same arguments as the kernel wrapper).

    Accumulates in float32 and rounds the upsampled intermediate to the
    input dtype, as the kernel does. Returns ``skip.dtype``, channels_last.
    """
    cin, cu4 = wt.shape
    cu = cu4 // 4
    c2, co = wc.shape[0] // 9, wc.shape[1]
    wt4 = wt.float().reshape(cin, 2, 2, cu).permute(0, 3, 1, 2)
    wc4 = wc.float().reshape(3, 3, c2, co).permute(3, 2, 0, 1)
    up = F.conv_transpose2d(y.float(), wt4, bt.float(), stride=2).to(y.dtype)
    z = torch.cat([up, skip], dim=1).float()
    out = F.conv2d(z, wc4, padding=1)
    out = torch.relu(out * scale.float().view(1, -1, 1, 1)
                     + bias.float().view(1, -1, 1, 1))
    return out.to(skip.dtype).contiguous(memory_format=torch.channels_last)


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


def _lib():
    lib = build.library("fused_up")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_up_convt.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.fused_up_convt.restype = i
        lib.fused_up_conv3x3.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.fused_up_conv3x3.restype = i
        lib._typed = True
    return lib


def fused_up_concat_conv(y, skip, wt, bt, wc, scale, bias):
    """relu(scale * conv3x3(concat(convT2x2s2(y) + bt, skip)) + bias).

    y: [B, Cin, Hc, Wc], skip: [B, Cs, 2Hc, 2Wc] (channels_last);
    wt: [Cin, 4*Cu] from :func:`pack_convt_kernel`; bt: [Cu];
    wc: [9*(Cu+Cs), Co] from :func:`pack_conv3x3_kernel` (up channels
    first); scale/bias: [Co], the folded conv bias and BatchNorm.
    Returns [B, Co, 2Hc, 2Wc] channels_last in ``skip.dtype``.

    CUDA tensors run the kernel (bf16 activations and weights, float32
    bt/scale/bias; anything else raises); CPU tensors run the reference.
    """
    if y.device.type == "cpu":
        return fused_up_concat_conv_reference(y, skip, wt, bt, wc, scale, bias)
    if y.device.type != "cuda":
        raise ValueError(f"fused_up_concat_conv runs on cuda or cpu, not {y.device}")
    b, cin, hc, wcs, cu, cs, co = _check_kernel_args(y, skip, wt, bt, wc, scale, bias)
    lib = _lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        up = torch.empty((b, cu, 2 * hc, 2 * wcs), dtype=torch.bfloat16, device=y.device,
                         memory_format=torch.channels_last)
        out = torch.empty((b, co, 2 * hc, 2 * wcs), dtype=torch.bfloat16, device=y.device,
                          memory_format=torch.channels_last)
        err = lib.fused_up_convt(y.data_ptr(), wt.data_ptr(), bt.data_ptr(), up.data_ptr(),
                                 b, hc, wcs, cin, cu, stream)
        if err:
            raise RuntimeError(f"fused_up_convt launch failed: cudaError {err}")
        err = lib.fused_up_conv3x3(up.data_ptr(), skip.data_ptr(), wc.data_ptr(),
                                   scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                   b, 2 * hc, 2 * wcs, cu, cs, co, stream)
        if err:
            raise RuntimeError(f"fused_up_conv3x3 launch failed: cudaError {err}")
    LAUNCHES["fused_up_concat_conv"] += 1
    return out
