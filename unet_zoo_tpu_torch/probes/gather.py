"""Probe: dynamic row gather (P1) on the card. Counterpart of the root
``_probe_gather.py``: a [4096, 128] float32 table, 4096 rows gathered by
int32 indices, checked against the plain version, then timed over 200
gathers with fresh indices (one CUDA graph of the launches, replayed, so the
device time is read without the launches' host cost).

Usage: python -m unet_zoo_tpu_torch.probes.gather [kernel|index_select] [N]
       (``--device cpu`` runs the plain version on the CPU)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from unet_zoo_tpu_torch.ops.kernels import row_gather as p1

ROWS = 4096          # table rows (one 64x64 image's padded pixels)
C = 128              # row width
N = 4096             # gathered rows


def run(variant: str, n: int = N, device=torch.device("cuda"), reps: int = 200):
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.standard_normal((ROWS, C)).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.integers(0, ROWS, size=n).astype(np.int32)).to(device)
    f = {"kernel": p1.row_gather, "index_select": p1.row_gather_reference}[variant]
    out = f(tab, idx)
    ref = tab.cpu().numpy()[idx.cpu().numpy()]
    err = float(np.abs(out.cpu().numpy() - ref).max())
    many = torch.from_numpy(rng.integers(0, ROWS, size=(reps, n)).astype(np.int32)).to(device)
    if device.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            f(tab, many[0])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(reps):
                f(tab, many[i])
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / reps
        where = torch.cuda.get_device_name(device)
    else:
        import time

        t0 = time.perf_counter()
        for i in range(reps):
            f(tab, many[i])
        dt = (time.perf_counter() - t0) / reps
        where = "the CPU"
    gbs = n * C * 4 / dt / 1e9
    print(f"{variant}: max_err={err:.2e}  {dt * 1e6:.1f} us/gather "
          f"({gbs:.0f} GB/s effective) on {where}")
    return dict(max_abs_err=err, us=dt * 1e6, gb_per_s=gbs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("variant", nargs="?", default="kernel", choices=["kernel", "index_select"])
    ap.add_argument("n", nargs="?", type=int, default=N)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain version")
    run(args.variant, args.n, device)


if __name__ == "__main__":
    main()
