"""P1: dynamic row gather, ``out[i] = tab[idx[i]]``.

Counterpart of the root probe ``_probe_gather.py::run``, whose Pallas kernel
gathers rows of a VMEM-resident [4096, 128] float32 table (the pattern of the
deformable conv's per-pixel corner reads). On a CUDA tensor
:func:`row_gather` launches ``csrc/row_gather.cu`` (a warp per row, float4
lanes); on a CPU tensor it runs :func:`row_gather_reference`,
``tab.index_select(0, idx)``, which is also the library call it is timed
against.
"""

from __future__ import annotations

import ctypes

import torch

from unet_zoo_tpu_torch.ops.kernels import build, refuse_export

# Times the wrapper launched the CUDA kernel (read by chip_smoke.py).
LAUNCHES = {"row_gather": 0}


def row_gather_reference(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_gather`."""
    return tab.index_select(0, idx.long())


def _fail(msg):
    raise ValueError(f"{msg}; use_kernels=False gathers with index_select")


def _lib():
    lib = build.library("row_gather")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.row_gather.argtypes = [p] * 3 + [i] * 3 + [p]
        lib.row_gather.restype = i
        lib._typed = True
    return lib


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [N] (int32, within [0, rows)) of ``tab`` [rows, C]
    (float32, C a multiple of 4): [N, C]. The kernel clamps an index outside
    the table to its nearest row; the plain version raises for it."""
    refuse_export("P1 (row_gather)", tab)
    if tab.device.type == "cpu":
        return row_gather_reference(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(f"row_gather runs on cuda or cpu, not {tab.device}")
    if tab.dim() != 2 or tab.dtype != torch.float32 or not tab.is_contiguous():
        _fail(f"tab must be contiguous float32 [rows, C], got {tab.dtype} {tuple(tab.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        _fail(f"idx must be contiguous int32 [N], got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != tab.device:
        _fail(f"idx is on {idx.device}, tab on {tab.device}")
    rows, c = tab.shape
    if c % 4 or rows == 0 or tab.numel() >= 2 ** 31 or idx.numel() * c >= 2 ** 31:
        _fail(f"the gather kernel takes C a multiple of 4 and fewer than 2^31 elements, "
              f"got {tuple(tab.shape)}")
    n = idx.numel()
    lib = _lib()
    with torch.cuda.device(tab.device):
        out = torch.empty(n, c, device=tab.device, dtype=tab.dtype)
        if n == 0:
            return out
        stream = torch.cuda.current_stream(tab.device).cuda_stream
        err = lib.row_gather(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, n, c, stream)
        if err:
            raise RuntimeError(f"row_gather launch failed: cudaError {err}")
    LAUNCHES["row_gather"] += 1
    return out
