"""Probe: where K4's device time goes, grid by grid, at each launch shape of
the B=8 ``mmunet`` forward (base 96, 256px).

For every (C, H = W) launch shape of the forward (``SHAPES``, with the
number of MKBlocks of that shape), the probe folds a seeded random MKBlock,
draws a seeded bf16 input and reads:

- ``ms``: one ``fused_mkblock`` call (weights folded and, where the tree
  packs them, packed once, as a served block has them), CUDA events around
  ``--iters`` back-to-back calls; ``graph_ms``: the same calls captured in
  one CUDA graph and replayed, the device time without the wrapper's host
  cost;
- ``grids``: each grid's device time per call by kernel name (the
  cascade, the MLP or each of its GEMMs), from ``torch.profiler`` over
  ``--iters`` calls, with its launches per call. The profiler now and then
  drops kernel records, so the trace is taken twice and the fuller one read.

It prints one line per shape and a JSON line with every reading. It imports
the port package found first on the path, so it reads another checkout of
the port when run as a file with that checkout first on ``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/mkblock_grids.py

Usage: python -m unet_zoo_tpu_torch.probes.mkblock_grids [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import re

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch.models.mmunet import MKBlock
from unet_zoo_tpu_torch.nn import init_weights
from unet_zoo_tpu_torch.ops.kernels import mkblock as k4

BATCH = 8
# mmunet (base 96) at 256px: (C, H = W, MKBlocks of that shape per forward)
SHAPES = [(96, 256, 4), (192, 128, 2), (192, 64, 4), (384, 32, 2), (768, 16, 2),
          (768, 8, 2), (384, 16, 2), (192, 32, 2), (96, 128, 2)]


def grid_name(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"\(.*$", "", name).strip()


def seeded_weights(c, device, seed):
    """A folded eval MKBlock with seeded weights, BN statistics and biases
    off identity (as chip_smoke.py's ``random_mkblock``)."""
    blk = MKBlock(c)
    g = torch.Generator().manual_seed(seed)
    init_weights(blk, g)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
    return [t.to(device) for t in k4.fold_mkblock_params(blk.eval())]


def events_ms(fn, iters):
    """Mean ms of ``fn()`` over ``iters`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device ms of ``fn()`` over ``iters`` calls captured in one CUDA
    graph and replayed: the wrapper's host cost stays out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def grid_split(fn, iters):
    """{grid name: (device ms per call, launches per call)} over ``iters``
    traced calls; the fuller of two traces."""
    from torch.profiler import ProfilerActivity, profile

    traces = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        traces.append([e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)])
    split = {}
    for e in max(traces, key=len):
        ms, n = split.get(grid_name(e.name), (0.0, 0))
        split[grid_name(e.name)] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: (ms / iters, n / iters) for k, (ms, n) in split.items()}


def measure(c, h, iters, device):
    weights = seeded_weights(c, device, c + h)
    gen = torch.Generator(device=device).manual_seed(c * 1000 + h)
    x = torch.randn(BATCH, c, h, h, generator=gen, device=device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    # a frozen block packs w1 and w2 once (a parent tree without packing
    # takes the folded weights as they are)
    kw = {}
    if hasattr(k4, "pack_mkblock_weights"):
        kw["packed"] = k4.pack_mkblock_weights(weights[2], weights[4])
    with torch.inference_mode():
        fn = lambda: k4.fused_mkblock(x, *weights, **kw)
        ms = events_ms(fn, iters)
        graph = graph_ms(fn, iters)
        grids = grid_split(fn, iters)
    return dict(x=[BATCH, c, h, h], ms=ms, graph_ms=graph, grids=grids)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times K4's grids on the card")
    device = torch.device("cuda")
    print(f"K4 grids on {torch.cuda.get_device_name(0)}, package "
          f"{unet_zoo_tpu_torch.__file__}", flush=True)
    rows = []
    for c, h, n in SHAPES:
        row = measure(c, h, args.iters, device)
        row["launches"] = n
        rows.append(row)
        parts = ", ".join(f"{k} {ms:.4f} ms x{cnt:g}" for k, (ms, cnt) in row["grids"].items())
        print(f"K4 x={row['x']} x{n}: {row['ms']:.4f} ms by events, {row['graph_ms']:.4f} ms "
              f"by graph; device {parts}", flush=True)
    per_forward = {}
    for r in rows:
        for k, (ms, _) in r["grids"].items():
            per_forward[k] = per_forward.get(k, 0.0) + ms * r["launches"]
    total = sum(r["ms"] * r["launches"] for r in rows)
    graph = sum(r["graph_ms"] * r["launches"] for r in rows)
    print(f"per forward: {total:.4f} ms by events, {graph:.4f} ms by graph; device "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in per_forward.items()), flush=True)
    print(json.dumps({"package": unet_zoo_tpu_torch.__file__, "shapes": rows,
                      "per_forward_ms": total, "per_forward_graph_ms": graph,
                      "per_forward_grids_ms": per_forward}), flush=True)


if __name__ == "__main__":
    main()
