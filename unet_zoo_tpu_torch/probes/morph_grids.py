"""Probe: where K5's device time goes, grid by grid, at each launch shape of
the B=8 ``mmunet`` forward (base 96, 256px), and the forward itself.

For every (C, H = W, repeat) launch shape of the forward (``SHAPES``, with
the number of morphology gates of that shape), the probe draws a seeded bf16
input (std 2, as chip_smoke.py does) and reads:

- ``ms``: one ``fused_softmax_morph`` call, CUDA events around ``--iters``
  back-to-back calls; ``graph_ms``: the same calls captured in one CUDA
  graph and replayed, the device time without the wrapper's host cost;
- ``grids``: each grid's device time per call by kernel name, from
  ``torch.profiler`` (the fuller of two traces), with its launches per call.

With ``--forward`` it also serves ``mmunet`` (registry widths, bf16, seeded
random weights, kernel path) at B=8/256px and reads img/s (median of 10
samples of 3 forwards, by CUDA events), the device's busy time per forward
from the profiler, the idle share, and K5's grids' share of the busy time.

It prints one line per reading and a JSON line with every reading. It
imports the port package found first on the path, so it reads another
checkout of the port when run as a file with that checkout first on
``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/morph_grids.py

Usage: python -m unet_zoo_tpu_torch.probes.morph_grids [--iters 20] [--forward]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.ops.kernels import morph as k5
from unet_zoo_tpu_torch.probes.mkblock_grids import events_ms, graph_ms, grid_split
from unet_zoo_tpu_torch.utils.serving import make_predictor

BATCH = 8
IMAGE = 256
# mmunet (base 96) at 256px: (C, H = W, repeat, gates of that shape per forward)
SHAPES = [(768, 16, 2, 1), (384, 32, 2, 1), (192, 64, 2, 1), (192, 128, 2, 1),
          (96, 256, 1, 2)]
K5_GRIDS = ("softmax_morph", "softmax_stats")   # kernel names of K5's grids


def measure(c, h, repeat, iters, device):
    gen = torch.Generator(device=device).manual_seed(c * 1000 + h)
    x = 2.0 * torch.randn(BATCH, c, h, h, generator=gen, device=device)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fn = lambda: k5.fused_softmax_morph(x, 7, repeat)
        ms = events_ms(fn, iters)
        graph = graph_ms(fn, iters)
        grids = grid_split(fn, iters)
    return dict(x=[BATCH, c, h, h], repeat=repeat, ms=ms, graph_ms=graph, grids=grids)


def forward(iters, device):
    """img/s, busy ms, idle share and K5's busy ms of the served B=8/256px
    mmunet forward on the kernel path."""
    model = create_model("mmunet", dtype=torch.bfloat16, device=device, seed=0)
    predict = make_predictor(model, None, "logits")
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
    with torch.inference_mode():
        for _ in range(3):
            predict(x)
        samples = [events_ms(lambda: predict(x), 3) for _ in range(10)]
        grids = grid_split(lambda: predict(x), 3)
    med = statistics.median(samples)
    busy = sum(ms for ms, _ in grids.values())
    ours = {k: v for k, v in grids.items() if any(g in k for g in K5_GRIDS)}
    return dict(img_per_s=BATCH / (med / 1e3), forward_ms=med, samples_ms=samples,
                busy_ms=busy, idle_share=1 - busy / med,
                k5_busy_ms=sum(ms for ms, _ in ours.values()), k5_grids=ours)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times K5's grids on the card")
    device = torch.device("cuda")
    print(f"K5 grids on {torch.cuda.get_device_name(0)}, package "
          f"{unet_zoo_tpu_torch.__file__}", flush=True)
    rows = []
    for c, h, repeat, n in SHAPES:
        row = measure(c, h, repeat, args.iters, device)
        row["launches"] = n
        rows.append(row)
        parts = ", ".join(f"{k} {ms:.4f} ms x{cnt:g}" for k, (ms, cnt) in row["grids"].items())
        print(f"K5 x={row['x']} repeat={repeat} x{n}: {row['ms']:.4f} ms by events, "
              f"{row['graph_ms']:.4f} ms by graph; device {parts}", flush=True)
    total = sum(r["ms"] * r["launches"] for r in rows)
    graph = sum(r["graph_ms"] * r["launches"] for r in rows)
    device_ms = sum(ms * r["launches"] for r in rows for ms, _ in r["grids"].values())
    print(f"per forward: {total:.4f} ms by events, {graph:.4f} ms by graph, "
          f"{device_ms:.4f} ms device", flush=True)
    out = {"package": unet_zoo_tpu_torch.__file__, "shapes": rows,
           "per_forward_ms": total, "per_forward_graph_ms": graph,
           "per_forward_device_ms": device_ms}
    if args.forward:
        out["forward"] = fwd = forward(args.iters, device)
        print(f"mmunet B={BATCH} {IMAGE}px kernel path: {fwd['img_per_s']:.1f} img/s "
              f"(forward {fwd['forward_ms']:.4f} ms), busy {fwd['busy_ms']:.4f} ms, idle "
              f"share {fwd['idle_share']:.3f}, K5 {fwd['k5_busy_ms']:.4f} ms", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
