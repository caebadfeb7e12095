"""Hand-written Hopper kernels (``csrc/``) and their plain PyTorch versions.

Modules here import no compiler or GPU package at import time; each kernel
is built on its first launch (``build.py``). Importing the package registers
the kernels that ``torch.export`` can carry as ops (``library.py``: K1 and
P2's conv in the ``unet_zoo`` namespace), which is all a process that loads
an exported predictor needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def use_kernel(use_kernels: Optional[bool], training: bool, x: torch.Tensor,
               fits: bool = True, trains: bool = False,
               dtypes: Tuple[torch.dtype, ...] = (torch.bfloat16,)) -> bool:
    """Whether a block runs its kernel on ``x``, the rule every model shares.

    ``use_kernels`` ``None`` runs it for CUDA activations of a type in
    ``dtypes`` (bfloat16, the kernels' type; the int8 conv, whose arithmetic
    is integer, takes float32 too); ``True`` on any device, which on the CPU
    means its plain version; ``False`` never. In training only a block with a
    train-mode kernel (``trains``: MedT's positional axis passes, K7) takes
    its kernel; every other block trains on its module path. ``fits`` is the
    block's shape gate: a block whose shape the kernel does not take runs its
    module path (a block with no gate leaves it True and lets the kernel's
    wrapper raise).
    """
    if use_kernels is False or not fits or (training and not trains):
        return False
    if use_kernels is None:
        return x.is_cuda and x.dtype in dtypes
    return True


def refuse_export(kernel: str, x: torch.Tensor) -> None:
    """Raise when a kernel that is not an op is reached while ``x`` is
    traced (``torch.export``, or any tracer of fake tensors): its ``ctypes``
    launch has no data to point at, and exporting its plain version in its
    place would serve another program than the one the model runs."""
    from torch._subclasses.fake_tensor import is_fake

    if torch.compiler.is_exporting() or is_fake(x):
        raise NotImplementedError(
            f"{kernel} is not an exportable op yet (ROADMAP Queue 1, item 14: the kernels "
            "beside K1 and P2's conv as exportable ops); export a model built with "
            "use_kernels=False to carry its plain path instead")


from unet_zoo_tpu_torch.ops.kernels import library  # noqa: E402,F401  (registers the ops)
