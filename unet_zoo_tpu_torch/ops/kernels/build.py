"""Builds the hand-written CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds); ``csrc/*.cuh`` are headers the sources share. All sources
compile in parallel, one ``nvcc`` each. The libraries land in ``_build/``
beside this file (listed in ``.gitignore``), named by a hash of source,
headers and flags, so an unchanged source is built once.
Nothing is built at import time: the first launch calls :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale ``csrc/*.cu`` in parallel; return {stem: .so path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    stale = {k: v for k, v in targets.items() if not v[1].exists()}
    if stale:
        nvcc = _nvcc()
        procs = {}
        for stem, (src, out) in stale.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[stem] = (tmp, out, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for stem, (tmp, out, proc) in procs.items():
            log = proc.communicate()[0]
            (BUILD_DIR / f"{stem}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{stem}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    with _LOCK:
        if stem not in _LIBS:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no CUDA source csrc/{stem}.cu")
            _LIBS[stem] = ctypes.CDLL(str(paths[stem]))
        return _LIBS[stem]
