"""K5: channel softmax, then ``repeat`` rounds of k x k dilation and erosion.

    sm = softmax_C(x); d = maxpool_k^repeat(sm); e = -maxpool_k^repeat(-sm)

each pool with SAME -inf padding, as ``max_pool2d(x, k, 1, k // 2)``.
Counterpart of ``unet_zoo_tpu/ops/pallas/morph.py::fused_softmax_morph``.
On a CUDA tensor :func:`fused_softmax_morph` launches the hand-written
Hopper kernel in ``csrc/morph.cu`` (one grid); on a CPU tensor it runs
:func:`fused_softmax_morph_reference`, the plain PyTorch version.
Activations are logical NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import build

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"fused_softmax_morph": 0}

# Channel counts the kernel takes: whole 8-channel (16-byte) chunks.
CHANNEL_ALIGN = 8
_TILE = 16            # output tile side of one block (csrc/morph.cu)
_MIN_BLOCKS = 264     # two blocks per SM of a 132-SM H100


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


def channel_groups(b: int, c: int, h: int, w: int) -> int:
    """Blocks that share one tile's channel chunks, so that small images
    still give the grid about ``_MIN_BLOCKS`` blocks."""
    tiles = b * -(-h // _TILE) * -(-w // _TILE)
    return max(1, min(c // CHANNEL_ALIGN, -(-_MIN_BLOCKS // tiles)))


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
        lib.softmax_morph.argtypes = [p, p, p] + [i] * 6 + [p]
        lib.softmax_morph.restype = i
        lib._typed = True
    return lib


def fused_softmax_morph(x: torch.Tensor, k: int = 7, repeat: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax over C, then ``repeat`` rounds of k x k (dilate, erode).

    x: [B, C, H, W] channels_last; returns (dilate, erode), each like x.
    CUDA tensors run the kernel (bf16, k = 7, repeat 1 or 2: mmunet's
    gates; anything else raises); CPU tensors run the reference.
    """
    if x.device.type == "cpu":
        return fused_softmax_morph_reference(x, k, repeat)
    if x.device.type != "cuda":
        raise ValueError(f"fused_softmax_morph runs on cuda or cpu, not {x.device}")
    b, c, h, w = _check_kernel_args(x, k, repeat)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        d = torch.empty_like(x, memory_format=torch.channels_last)
        e = torch.empty_like(x, memory_format=torch.channels_last)
        err = lib.softmax_morph(x.data_ptr(), d.data_ptr(), e.data_ptr(), b, h, w, c, repeat,
                                channel_groups(b, c, h, w), stream)
        if err:
            raise RuntimeError(f"softmax_morph launch failed: cudaError {err}")
    LAUNCHES["fused_softmax_morph"] += 1
    return d, e
