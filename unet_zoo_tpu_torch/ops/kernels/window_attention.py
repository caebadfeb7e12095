"""K2: SwinV2 cosine window attention, fused.

For each window b, head h and query i:

    a[i, j] = (q_i·k_j / max(|q_i| |k_j|, 1e-6)) / max(tau[h,i,j], 0.01)
              + bias[h,i,j] + mask[b % nW, i, j]
    out[i]  = Σ_j softmax_j(a[i, :]) v_j

with q already multiplied by the attention scale (it cancels in the cosine
but for the 1e-6 clamp), ``tau`` a per-element divisor clipped from below
only, ``bias`` the continuous relative position bias (the CPB table) and
``mask`` the 0 / -100 shift mask, absent for unshifted windows. All
arithmetic is float32; the output is rounded to the input type once.
Counterpart of ``unet_zoo_tpu/ops/pallas/window_attention.py::
swin_window_attention``, without its window blocking.

On a CUDA tensor :func:`swin_window_attention` launches the hand-written
Hopper kernel in ``csrc/window_attention.cu`` (one grid); on a CPU tensor it
runs :func:`swin_window_attention_reference`, the plain PyTorch version.
q, k and v are [B_, nh, N, hd] as in JAX, in any strides whose last one is
1, so the model hands over views of its qkv projection.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from unet_zoo_tpu_torch.ops.kernels import build

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"swin_window_attention": 0}

MAX_TOKENS = 256        # N: 8 keys per lane of a warp
MAX_HEAD_DIM = 128
_NWARPS = 4             # warps of a block (csrc/window_attention.cu)
_SMEM_LIMIT = 200 * 1024


def _clip_tau(tau: torch.Tensor) -> torch.Tensor:
    """``clip(tau, 0.01)``: a lower bound only, as float32."""
    return tau.float().clamp_min(0.01)


def swin_window_attention_reference(q, k, v, tau, bias, mask=None) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arguments as the kernel wrapper):
    float32 throughout, as ``window_attention.py:114-128``; returns
    [B_, nh, N, hd] in ``q.dtype``. ``mask`` None is no mask."""
    b_, nh, n, _ = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    dots = q32 @ k32.transpose(-1, -2)
    qn = torch.linalg.vector_norm(q32, dim=-1)[..., :, None]
    kn = torch.linalg.vector_norm(k32, dim=-1)[..., None, :]
    attn = dots / torch.clamp_min(qn * kn, 1e-6)
    attn = attn / _clip_tau(tau)[None]
    attn = attn + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, nh, n, n) + mask.float()[None, :, None]
        attn = attn.reshape(b_, nh, n, n)
    attn = torch.softmax(attn, dim=-1)
    return (attn @ v32).to(q.dtype)


def smem_bytes(n: int, hd: int) -> int:
    """Shared memory of one block (``smem_bytes`` in csrc/window_attention.cu)."""
    ld = hd | 1
    return 4 * (2 * n * ld + n * hd + 2 * n + _NWARPS * n)


def _check_kernel_args(q, k, v, tau, bias, mask):
    """The kernel's argument checks; every error names the module path."""
    def fail(msg):
        raise ValueError(f"{msg}; use_kernels=False runs such a model on its module path")

    if q.dim() != 4:
        fail(f"q must be [B_, nh, N, hd], got {tuple(q.shape)}")
    b_, nh, n, hd = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            fail(f"{name} is {tuple(t.shape)}, q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            fail(f"q, k and v must share torch.bfloat16 or torch.float32, {name} is {t.dtype}")
        if t.stride(-1) != 1:
            fail(f"{name}'s last dimension must be contiguous")
        if t.device != q.device:
            fail(f"{name} is on {t.device}, q on {q.device}")
    if not 1 <= n <= MAX_TOKENS:
        fail(f"the K2 kernel takes windows of up to {MAX_TOKENS} tokens, not {n}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        fail(f"the K2 kernel takes head widths up to {MAX_HEAD_DIM}, not {hd}")
    if smem_bytes(n, hd) > _SMEM_LIMIT:
        fail(f"N={n}, hd={hd} does not fit the K2 kernel's shared memory")
    nw = 1
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n) or mask.shape[0] < 1:
            fail(f"mask must be [nW, {n}, {n}], got {tuple(mask.shape)}")
        nw = mask.shape[0]
        if b_ % nw:
            fail(f"nW={nw} does not divide B_={b_}")
    for name, t, shape in (("tau", tau, (nh, n, n)), ("bias", bias, (nh, n, n)),
                           ("mask", mask, None)):
        if t is None:
            continue
        if shape is not None and tuple(t.shape) != shape:
            fail(f"{name} is {tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            fail(f"{name} must be torch.float32, got {t.dtype}")
        if t.device != q.device:
            fail(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            fail(f"{name} must be contiguous")
    if b_ * nh >= 2**31:
        fail("more than 2^31 (window, head) pairs")
    return b_, nh, n, hd, nw


def _lib():
    lib = build.library("window_attention")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.window_attention.argtypes = [p] * 7 + [i] * 6 + [ll] * 12 + [p]
        lib.window_attention.restype = i
        lib._typed = True
    return lib


def swin_window_attention(q, k, v, tau, bias, mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """SwinV2 window attention of every (window, head).

    q, k, v: [B_, nh, N, hd] (q already scaled), B_ = batch x windows;
    tau, bias: [nh, N, N] float32; mask: [nW, N, N] float32 with nW
    dividing B_ (window b reads ``mask[b % nW]``), or None. Returns [B_,
    nh, N, hd] in ``q.dtype``; on the card its memory is [B_, N, nh, hd],
    the token-major layout the output projection reads.

    CUDA tensors run the kernel (bf16 or float32 q, k, v; anything the
    kernel does not take raises); CPU tensors run the reference.
    """
    if q.device.type == "cpu":
        return swin_window_attention_reference(q, k, v, tau, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"swin_window_attention runs on cuda or cpu, not {q.device}")
    b_, nh, n, hd, nw = _check_kernel_args(q, k, v, tau, bias, mask)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        out = torch.empty((b_, n, nh, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        err = lib.window_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tau.data_ptr(),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            b_, nh, n, hd, nw, int(q.dtype == torch.float32), *strides, stream)
        if err:
            raise RuntimeError(f"window_attention launch failed: cudaError {err}")
    LAUNCHES["swin_window_attention"] += 1
    return out
