"""K3: SAME, stride-1, k x k depthwise convolution plus bias, channels-last.

    out[b, y, x, c] = sum_{dy, dx} xpad[b, y + dy, x + dx, c] * kernel[dy, dx, c] + bias[c]

x [B, H, W, C] zero-padded by (k - 1) / 2, kernel [k, k, C], bias [C] or
None; taps accumulate in float32, the bias is added in float32 and the
result is rounded to x's type once. Counterpart of
``unet_zoo_tpu/ops/pallas/depthwise.py::depthwise_conv2d``, without its
channel blocking. In bfloat16 the kernel and bias arrive rounded to
bfloat16, as the JAX ``DWConv`` casts them.

On a CUDA tensor :func:`depthwise_conv2d` launches the hand-written Hopper
kernel in ``csrc/depthwise.cu`` (one grid); on a CPU tensor it runs
:func:`depthwise_conv2d_reference`, the plain PyTorch version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"depthwise_conv2d": 0}

KERNEL_SIZES = (3, 5, 7)


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


def _lib():
    lib = build.library("depthwise")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.depthwise_conv.argtypes = [p] * 4 + [i] * 6 + [p]
        lib.depthwise_conv.restype = i
        lib._typed = True
    return lib


def depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME stride-1 depthwise conv of x [B, H, W, C] with kernel [k, k, C]
    and bias [C] or None; returns [B, H, W, C] in ``x.dtype``.

    CUDA tensors run the kernel (bf16 or float32, k 3, 5 or 7; anything the
    kernel does not take raises); CPU tensors run the reference.
    """
    if x.device.type == "cpu":
        return depthwise_conv2d_reference(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv2d runs on cuda or cpu, not {x.device}")
    b, h, w, c, k = _check_kernel_args(x, kernel, bias)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        out = torch.empty_like(x)
        err = lib.depthwise_conv(x.data_ptr(), kernel.data_ptr(),
                                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                                 b, h, w, c, k, int(x.dtype == torch.float32), stream)
        if err:
            raise RuntimeError(f"depthwise_conv launch failed: cudaError {err}")
    LAUNCHES["depthwise_conv2d"] += 1
    return out
