"""Probe: K1's device time at each decoder stage of the B=8 ``unet`` forward
(256px), grid by grid, and the forward itself.

For every stage (``STAGES``: y [8, Cin, Hc, Hc], skip [8, Cu, 2Hc, 2Hc],
Co = Cu = Cin / 2) the probe draws seeded bf16 operands (chip_smoke.py's
``stage_case`` scales), packs the weights once as a served stage has them,
and reads:

- ``ms``: one ``fused_up_concat_conv`` call, CUDA events around ``--iters``
  back-to-back calls; ``graph_ms``: the same calls captured in one CUDA
  graph and replayed, the device time without the wrapper's host cost;
- ``grids``: each grid's device time per call (the ConvT GEMM and the 3x3
  conv), from ``torch.profiler`` over ``--iters`` eager calls, and
  ``graph_grids``: the same over replays of the CUDA graph;
- TFLOP/s of the call and of each grid, and the stage's bound (operations
  at 989 TFLOP/s bf16 against bytes at 3.35 TB/s, the larger).

With ``--forward`` it serves ``unet`` (bf16, seed 0) on the kernel path at
B=8/256px and reads img/s (median of 10 samples of 3 forwards, by CUDA
events), the device's busy time per forward from the profiler, the idle
share, and K1's busy ms.

It prints one line per reading and a JSON line with every reading. It
imports the port package found first on the path, so it reads another
checkout of the port when run as a file with that checkout first on
``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/fused_up_grids.py

Usage: python -m unet_zoo_tpu_torch.probes.fused_up_grids [--iters 20] [--forward]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
from unet_zoo_tpu_torch.probes.mkblock_grids import events_ms, graph_ms, grid_name, grid_split
from unet_zoo_tpu_torch.utils.serving import make_predictor

BATCH = 8
IMAGE = 256
# (Cin, Cu, Hc) of unet's four decoder stages at 256px; Cs = Co = Cu
STAGES = [(1024, 512, 16), (512, 256, 32), (256, 128, 64), (128, 64, 128)]
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def stage_case(cin, cu, hc, device):
    """Seeded bf16 operands of one stage (y, skip, wt, bt, wc, scale, bias)."""
    gen = torch.Generator(device=device).manual_seed(cin * 1000 + hc)
    n = lambda *s: torch.randn(*s, generator=gen, device=device)
    cl, bf = torch.channels_last, torch.bfloat16
    cs = co = cu
    return (n(BATCH, cin, hc, hc).to(bf).contiguous(memory_format=cl),
            n(BATCH, cs, 2 * hc, 2 * hc).to(bf).contiguous(memory_format=cl),
            (n(cin, 4 * cu) / cin ** 0.5).to(bf), n(cu) * 0.1,
            (n(9 * (cu + cs), co) * (2.0 / (9 * (cu + cs))) ** 0.5).to(bf),
            1.0 + 0.2 * n(co), 0.1 * n(co))


def work(cin, cu, hc):
    """(ConvT FLOPs, conv FLOPs, least bytes) of one stage: each input read
    once, the output written once."""
    hf, cs = 2 * hc, cu
    convt = 2 * BATCH * hc * hc * cin * 4 * cu
    conv = 2 * BATCH * hf * hf * 9 * (cu + cs) * cu
    nbytes = (2 * (BATCH * hc * hc * cin + BATCH * hf * hf * (cs + cu)
                   + cin * 4 * cu + 9 * (cu + cs) * cu) + 4 * 3 * cu)
    return convt, conv, nbytes


def grid_kind(name: str) -> str:
    """'convt' or 'conv3x3' for one of K1's grids (this tree's
    ``fused_up_convt``/``fused_up_conv3x3``, or an older tree's
    ``fused_up_gemm<false|true, ...>``), else the name."""
    if "fused_up" not in name:
        return name
    return "convt" if ("convt" in name or "<false" in name) else "conv3x3"


def by_kind(grids):
    out = {}
    for name, (ms, n) in grids.items():
        k = grid_kind(name)
        ms0, n0 = out.get(k, (0.0, 0.0))
        out[k] = (ms0 + ms, n0 + n)
    return out


def graph_grid_split(fn, iters):
    """{grid name: (device ms per call, launches per call)} from the profiler
    over two replays of a CUDA graph of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    traces = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        traces.append([e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)])
    split = {}
    for e in max(traces, key=len):
        ms, n = split.get(grid_name(e.name), (0.0, 0))
        split[grid_name(e.name)] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return {k: (ms / iters, n / iters) for k, (ms, n) in split.items()}


def measure(cin, cu, hc, iters, device):
    args = stage_case(cin, cu, hc, device)
    kw = {}
    if hasattr(k1, "pack_kernel_weights"):  # a tree whose kernel takes K-major weights
        kw["packed"] = k1.pack_kernel_weights(args[2], args[4])
    with torch.inference_mode():
        fn = lambda: k1.fused_up_concat_conv(*args, **kw)
        ms = events_ms(fn, iters)
        graph = graph_ms(fn, iters)
        grids = by_kind(grid_split(fn, iters))
        ggrids = by_kind(graph_grid_split(fn, iters))
    convt, conv, nbytes = work(cin, cu, hc)
    bound_ms = 1e3 * max((convt + conv) / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    flops = {"convt": convt, "conv3x3": conv}
    tflops = {k: flops[k] / ms_ / 1e9 for k, (ms_, _) in ggrids.items() if k in flops}
    return dict(y=[BATCH, cin, hc, hc], co=cu, ms=ms, graph_ms=graph, grids=grids,
                graph_grids=ggrids, tflops=(convt + conv) / graph / 1e9,
                graph_grid_tflops=tflops, bound_ms=bound_ms,
                grid_bound_ms={k: 1e3 * f / PEAK_BF16_FLOPS for k, f in flops.items()})


def forward(iters, device):
    """img/s, busy ms, idle share and K1's busy ms of the B=8/256px bf16 unet
    forward on the kernel path."""
    predict = make_predictor(create_model("unet", dtype=torch.bfloat16, device=device, seed=0),
                             None, "logits")
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
    with torch.inference_mode():
        for _ in range(3):
            predict(x)
        samples = [events_ms(lambda: predict(x), 3) for _ in range(10)]
        grids = grid_split(lambda: predict(x), 3)
    med = statistics.median(samples)
    busy = sum(ms for ms, _ in grids.values())
    ours = {k: v for k, v in grids.items() if "fused_up" in k}
    return dict(img_per_s=BATCH / (med / 1e3), forward_ms=med, samples_ms=samples,
                busy_ms=busy, idle_share=1 - busy / med,
                k1_busy_ms=sum(ms for ms, _ in ours.values()), k1_grids=ours,
                top=sorted(grids.items(), key=lambda kv: -kv[1][0])[:8])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times K1 on the card")
    device = torch.device("cuda")
    print(f"K1 on {torch.cuda.get_device_name(0)}, package {unet_zoo_tpu_torch.__file__}",
          flush=True)
    rows = [measure(cin, cu, hc, args.iters, device) for cin, cu, hc in STAGES]
    for r in rows:
        parts = ", ".join(f"{k} {ms:.4f} ms x{n:g} (graph {r['graph_grids'].get(k, (0, 0))[0]:.4f}"
                          f", {r['graph_grid_tflops'].get(k, 0):.1f} TFLOP/s)"
                          for k, (ms, n) in r["grids"].items())
        print(f"K1 y={r['y']} Co={r['co']}: {r['ms']:.4f} ms by events, {r['graph_ms']:.4f} ms "
              f"by graph ({r['tflops']:.1f} TFLOP/s), bound {r['bound_ms']:.4f} ms; device "
              f"{parts}", flush=True)
    out = {"package": unet_zoo_tpu_torch.__file__, "stages": rows,
           "per_forward_ms": sum(r["ms"] for r in rows),
           "per_forward_graph_ms": sum(r["graph_ms"] for r in rows),
           "per_forward_bound_ms": sum(r["bound_ms"] for r in rows)}
    print(f"per forward: {out['per_forward_ms']:.4f} ms by events, "
          f"{out['per_forward_graph_ms']:.4f} ms by graph, bound "
          f"{out['per_forward_bound_ms']:.4f} ms", flush=True)
    if args.forward:
        out["forward"] = fwd = forward(args.iters, device)
        print(f"unet B={BATCH} {IMAGE}px kernel path: {fwd['img_per_s']:.1f} img/s "
              f"(forward {fwd['forward_ms']:.4f} ms), busy {fwd['busy_ms']:.4f} ms, idle "
              f"share {fwd['idle_share']:.3f}, K1 {fwd['k1_busy_ms']:.4f} ms; top grids "
              f"{[(k, round(v[0], 4)) for k, v in fwd['top']]}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
