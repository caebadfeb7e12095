"""Probe: does the hand-written int8 GEMM (P2) reach twice the bf16 rate on
this card? Counterpart of the root ``_probe_int8_mosaic.py``: the same
kernel tiling for bf16 and int8 operands, timed on the card.

The H100's tensor cores run dense int8 at 1,979 TOP/s, twice bf16's 989
TFLOP/s. Each case draws fresh seeded operands on the device, checks one
product against the plain version (int8 exactly, bf16 within 1e-5 sqrt(K)
of the output rms), then times ``--steps`` back-to-back launches with CUDA
events after a warm-up.

Usage: python -m unet_zoo_tpu_torch.probes.int8_matmul [--m 4096 --n 4096 --k 4096]
       [--steps 20] [--bm 128 --bn 256] [--case all|bf16|int8] [--device cuda]

``--bm``/``--bn`` pick the kernel's block tile, 128 x 64, 128 x 128 or
128 x 256 (``int8_gemm.GEMM_TILES``). ``--bk`` is the TPU kernel's K tile;
the Hopper kernel streams K through a ring of 128-byte stages instead, so
only 0 (the whole K) is taken.
"""

from __future__ import annotations

import argparse

import torch

from unet_zoo_tpu_torch.ops.kernels import int8_gemm

TILES = int8_gemm.GEMM_TILES


def operands(m, n, k, dtype, seed, device):
    """Seeded operands on ``device``: int8 uniform in [-127, 127), bf16 normal."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.int8:
        draw = lambda *s: torch.randint(-127, 127, s, generator=gen, device=device,
                                        dtype=torch.int8)
    else:
        draw = lambda *s: torch.randn(*s, generator=gen, device=device).to(dtype)
    return draw(m, k), draw(n, k)


def bench_case(name, m, n, k, dtype, steps, tile, device):
    a, bt = operands(m, n, k, dtype, 1, device)
    got = int8_gemm.matmul(a, bt, tile=tile)
    ref = int8_gemm.matmul_reference(a, bt)
    if dtype == torch.int8:
        err = (got.long() - ref.long()).abs().max().item()
        ok = err == 0
    else:
        err = (got - ref).abs().max().item()
        ok = err <= 1e-5 * k ** 0.5 * ref.pow(2).mean().sqrt().item()
    if not ok:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version ({err})")
    a, bt = operands(m, n, k, dtype, 101, device)   # fresh data for the timed launches
    if device.type == "cuda":
        int8_gemm.matmul(a, bt, tile=tile)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            int8_gemm.matmul(a, bt, tile=tile)
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        import time

        t0 = time.perf_counter()
        for _ in range(steps):
            int8_gemm.matmul(a, bt, tile=tile)
        dt = time.perf_counter() - t0
    flops = 2 * m * n * k * steps
    unit = "OP" if dtype == torch.int8 else "F"
    print(f"{name}: {dt * 1e3:.1f} ms for {steps} matmuls -> {flops / dt / 1e12:.1f} T{unit}/s "
          f"on {device_name(device)} (max_err {err:.3e})")
    return dt


def device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU (plain version)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--bm", type=int, default=128)
    ap.add_argument("--bn", type=int, default=256)
    ap.add_argument("--bk", type=int, default=0, choices=[0])
    ap.add_argument("--case", default="all", choices=["all", "bf16", "int8"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.bm, args.bn) not in TILES:
        ap.error(f"--bm/--bn must be one of {TILES}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain version")
    m, n, k, s, tile = args.m, args.n, args.k, args.steps, (args.bm, args.bn)

    t16 = t8 = None
    if args.case in ("all", "bf16"):
        t16 = bench_case("hopper bf16xbf16->f32", m, n, k, torch.bfloat16, s, tile, device)
    if args.case in ("all", "int8"):
        t8 = bench_case("hopper s8xs8->s32   ", m, n, k, torch.int8, s, tile, device)
    if t16 and t8:
        print(f"int8 vs bf16 ratio: {t16 / t8:.2f}x "
              f"({'2x path REACHED' if t16 / t8 > 1.5 else 'below the 2x path'})")


if __name__ == "__main__":
    main()
