"""Probe: K3's time at each launch shape of the B=8 ``unext`` and ``unext_s``
forwards (registry defaults, 256px: one launch a MiT block on the hidden
width 4 x dim at each stage's resolution), and the forwards themselves.

For every launch shape [B, H, W, C] (with the number of launches of that
shape in one forward) the probe draws seeded bf16 operands (x, a [3, 3, C]
kernel of O(1/3) taps, a bias) and reads:

- ``ms``: one ``depthwise_conv2d`` call, CUDA events around ``--iters``
  back-to-back calls; ``graph_ms``: the same calls captured in one CUDA
  graph and replayed, the device time without the wrapper's host cost (the
  same x each call: the launches below 50 MB read it from L2);
  ``host_us``: the wrapper's host time a call, the CPU's wall time to issue
  ``--iters`` calls back to back (median of 5);
- ``grids``: each grid's device time per call by kernel name, from
  ``torch.profiler`` (the fuller of two traces), with its launches per call;
- ``bound_ms``: the least bytes (x read and the output written once, the
  taps and bias once, bf16) over 3.35 TB/s, which bound K3 (2 k^2 f32
  operations an output are far below the ridge), and ``gb_s``, the least
  bytes over ``graph_ms``.

With ``--sweep`` it also times, by graph, the stream instance at every
chunk width, band height (every distinct ceil(H / n)) and ring it has, launching
the source's entry through ``depthwise.run_stream`` (a checkout with the
stream instance), and prints how far the plan's pick is from the fastest.
With ``--forward`` it serves ``unext`` and ``unext_s`` (bf16, seeded random
weights, kernel path) at B=8/256px and reads img/s (median of 10 samples of
3 forwards, by CUDA events), the device's busy time per forward from the
profiler, the idle share, K3's share of the busy time, and each K3 launch's
device time inside the forward, where the caller's operands lie.

It prints one line per reading and a JSON line with every reading. It
imports the port package found first on the path, so it reads another
checkout of the port when run as a file with that checkout first on
``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/depthwise_grids.py

Usage: python -m unet_zoo_tpu_torch.probes.depthwise_grids [--iters 20] [--sweep] [--forward]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
from unet_zoo_tpu_torch.probes.mkblock_grids import events_ms, graph_ms, grid_split
from unet_zoo_tpu_torch.probes.window_grids import host_us
from unet_zoo_tpu_torch.utils.serving import make_predictor

BATCH = 8
IMAGE = 256
# registry defaults: embed dims and the three stage depths
CONFIGS = {"unext": ((128, 160, 256), (3, 4, 6)), "unext_s": ((64, 128, 160), (2, 2, 2))}
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
K3_GRID = "depthwise"      # in the name of every K3 grid, parent's and change's


def launch_shapes(name, image=IMAGE, batch=BATCH):
    """K3's launches in one forward of registry-default ``name``: rows of
    (B, H, W, C, launches), C = 4 dim at stage s's resolution image / 2^(s+2)."""
    dims, depths = CONFIGS[name]
    return [(batch, image >> (s + 2), image >> (s + 2), 4 * d, n)
            for s, (d, n) in enumerate(zip(dims, depths))]


def least_bytes(b, h, w, c, k=3):
    """x read and the output written once, the taps and bias once (bf16)."""
    return 2 * (2 * b * h * w * c + k * k * c + c)


def operands(b, h, w, c, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    return (r(b, h, w, c).to(torch.bfloat16), (r(3, 3, c) / 3).to(torch.bfloat16),
            r(c).to(torch.bfloat16))


def sweep(args, iters):
    """{layout: graph ms} over the stream instance's layouts at this shape,
    and the plan's layout."""
    x = args[0]
    b, h, w, c = x.shape
    out = {}
    for lcv in k3.LCVS:
        if k3.STREAM_THREADS >> lcv > max(w, 16):
            continue
        for bh in sorted({-(-h // n) for n in range(1, h + 1)}):
            for ring in k3.RINGS:
                p = k3.layout(b, h, w, c, lcv, bh, ring)
                out[f"cv{p.cv}/bh{bh}/ring{ring}"] = graph_ms(
                    lambda: k3.run_stream(*args, p), iters)
    p = k3.plan(b, h, w, c)
    return out, f"cv{p.cv}/bh{p.bh}/ring{p.ring}"


def measure(shape, iters, do_sweep, device):
    b, h, w, c, launches = shape
    args = operands(b, h, w, c, device, b * 1000 + h + c)
    with torch.inference_mode():
        fn = lambda: k3.depthwise_conv2d(*args)
        ms = events_ms(fn, iters)
        graph = graph_ms(fn, iters)
        host = host_us(fn, iters)
        grids = grid_split(fn, iters)
        swept = sweep(args, iters) if do_sweep else None
    nbytes = least_bytes(b, h, w, c)
    row = dict(shape=[b, h, w, c], launches=launches, ms=ms, graph_ms=graph, host_us=host,
               grids=grids, bound_ms=1e3 * nbytes / PEAK_HBM_BYTES, bound_by="bytes",
               gb_s=nbytes / graph / 1e6)
    if hasattr(k3, "plan"):
        row["plan"] = k3.plan(b, h, w, c)._asdict()
    if swept is not None:
        row["sweep_graph_ms"], row["plan_key"] = swept
    return row


def k3_launches_in_forward(fn, iters):
    """Each K3 launch's device ms inside the forward, in launch order: the
    mean over ``iters`` traced forwards (the fuller of two traces)."""
    from torch.profiler import ProfilerActivity, profile

    traces = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and K3_GRID in e.name),
                    key=lambda e: e.time_range.start)
        traces.append([e.time_range.elapsed_us() / 1e3 for e in ev])
    durs = max(traces, key=len)
    per = len(durs) // iters
    return [sum(durs[i * per + j] for i in range(iters)) / iters for j in range(per)]


def forward(name, iters, device):
    """img/s, busy ms, idle share and K3's busy ms of the served B=8 forward
    on the kernel path."""
    model = create_model(name, dtype=torch.bfloat16, device=device, seed=0)
    predict = make_predictor(model, None, "logits")
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)
    with torch.inference_mode():
        for _ in range(3):
            predict(x)
        samples = [events_ms(lambda: predict(x), 3) for _ in range(10)]
        grids = grid_split(lambda: predict(x), 3)
        launches = k3_launches_in_forward(lambda: predict(x), 3)
    med = statistics.median(samples)
    busy = sum(ms for ms, _ in grids.values())
    ours = {k: v for k, v in grids.items() if K3_GRID in k}
    k3_ms = sum(ms for ms, _ in ours.values())
    return dict(model=name, img_per_s=BATCH / (med / 1e3), forward_ms=med, samples_ms=samples,
                busy_ms=busy, idle_share=1 - busy / med, k3_busy_ms=k3_ms,
                k3_share_of_busy=k3_ms / busy, k3_grids=ours, k3_launch_ms=launches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times K3 on the card")
    device = torch.device("cuda")
    print(f"K3 on {torch.cuda.get_device_name(0)}, package {unet_zoo_tpu_torch.__file__}",
          flush=True)
    out = {"package": unet_zoo_tpu_torch.__file__, "device": torch.cuda.get_device_name(0)}
    for name in CONFIGS:
        rows = []
        for shape in launch_shapes(name):
            row = measure(shape, args.iters, args.sweep, device)
            rows.append(row)
            parts = ", ".join(f"{k} {ms:.4f} ms x{cnt:g}" for k, (ms, cnt) in row["grids"].items())
            extra = ""
            if args.sweep:
                swept = row["sweep_graph_ms"]
                best = min(swept, key=swept.get)
                extra = (f"; plan {row['plan_key']} {swept[row['plan_key']]:.4f} ms, fastest "
                         f"{best} {swept[best]:.4f} ms")
            print(f"K3 {name} {shape[:4]} x{shape[4]}: {row['ms']:.4f} ms by events, "
                  f"{row['graph_ms']:.4f} ms by graph, host {row['host_us']:.1f} us a call, "
                  f"bound {row['bound_ms']:.4f} ms (bytes), {row['gb_s']:.1f} GB/s; device "
                  f"{parts}{extra}", flush=True)
        per = lambda k: sum(r[k] * r["launches"] for r in rows)
        device_ms = sum(ms * r["launches"] for r in rows for ms, _ in r["grids"].values())
        print(f"per {name} forward: {per('ms'):.4f} ms by events, {per('graph_ms'):.4f} ms by "
              f"graph, {device_ms:.4f} ms device, host {per('host_us'):.1f} us, bound "
              f"{per('bound_ms'):.4f} ms", flush=True)
        out[name] = {"shapes": rows, "per_forward_ms": per("ms"),
                     "per_forward_graph_ms": per("graph_ms"), "per_forward_device_ms": device_ms,
                     "per_forward_host_us": per("host_us"), "per_forward_bound_ms": per("bound_ms")}
    if args.forward:
        for name in CONFIGS:
            out[name]["forward"] = fwd = forward(name, args.iters, device)
            print(f"{name} B={BATCH} {IMAGE}px kernel path: {fwd['img_per_s']:.1f} img/s "
                  f"(forward {fwd['forward_ms']:.4f} ms), busy {fwd['busy_ms']:.4f} ms, idle "
                  f"share {fwd['idle_share']:.3f}, K3 {fwd['k3_busy_ms']:.4f} ms "
                  f"({fwd['k3_share_of_busy']:.3f} of busy); K3 launches in the forward "
                  + ", ".join(f"{ms:.4f}" for ms in fwd["k3_launch_ms"]), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
