"""Probe: K2's time at each launch shape of the B=8 ``swin_unet_v2`` forward
(registry defaults: embed 96, heads (3, 6, 12, 24), hd 32) at 224px/window 7
and 256px/window 8, and the forwards themselves.

For every launch shape (``window_attention.launch_shapes``: B_, nh, N, hd,
nW, with the number of SwinBlockV2 launches of that shape in one forward),
the probe
draws a seeded bf16 projection [B_, N, 3, nh, hd] whose k and v views K2
reads as the model hands them over (q scaled and contiguous), tau from
U(0.1, 1), a CPB-like bias of std 2 and the model's own shift mask, and
reads:

- ``ms``: one ``swin_window_attention`` call, CUDA events around
  ``--iters`` back-to-back calls; ``graph_ms``: the same calls captured in
  one CUDA graph and replayed, the device time without the wrapper's host
  cost; ``host_us``: the wrapper's host time a call, the CPU's wall time to
  issue ``--iters`` calls back to back (median of 5; the device queue does
  not fill, so the device time does not enter it);
- ``grids``: each grid's device time per call by kernel name, from
  ``torch.profiler`` (the fuller of two traces), with its launches per call;
- ``bound_ms``: the larger of the least bytes (q, k, v read and the output
  written once in bf16, the float32 tables once) over 3.35 TB/s and the
  operations on their units (``window_attention.work``, which chip_smoke.py
  counts too), and ``gb_s``, the least bytes over ``graph_ms``.

With ``--sweep`` it also times, by graph, every number of windows a block
the mma instance can take at each shape, launching the source's entry
``window_attention_mma`` directly (a checkout with the mma instance). With ``--forward`` it serves
``swin_unet_v2`` (bf16, seeded random weights, kernel path) at B=8 in both
configurations and reads img/s (median of 10 samples of 3 forwards, by CUDA
events), the device's busy time per forward from the profiler, the idle
share, and K2's share of the busy time.

It prints one line per reading and a JSON line with every reading. It
imports the port package found first on the path, so it reads another
checkout of the port (one whose ``ops/kernels/window_attention.py`` has
``launch_shapes`` and ``work``) when run as a file with that checkout first
on ``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/window_grids.py

Usage: python -m unet_zoo_tpu_torch.probes.window_grids [--iters 20] [--sweep] [--forward]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.swin_unet_v2 import _shift_attn_mask
from unet_zoo_tpu_torch.ops.kernels import window_attention as k2
from unet_zoo_tpu_torch.probes.mkblock_grids import events_ms, graph_ms, grid_split
from unet_zoo_tpu_torch.utils.serving import make_predictor

BATCH = 8
CONFIGS = [(224, 7), (256, 8)]
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
K2_GRID = "window_attention"   # in the name of every K2 grid, parent's and change's


def bound_ms(b_, nh, n, hd, nw):
    """K2's work (``window_attention.work``) over the card's peaks: (ms, what
    bounds it, least bytes)."""
    tc, f32, nbytes = k2.work(b_, nh, n, hd, nw)
    t_ops = max(tc / PEAK_BF16_FLOPS, f32 / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", nbytes


def host_us(fn, iters):
    """The host's wall time a call to issue ``iters`` calls back to back,
    median of 5, in microseconds."""
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        samples.append(1e6 * (time.perf_counter() - t0) / iters)
    torch.cuda.synchronize()
    return statistics.median(samples)


def operands(b_, nh, n, hd, nw, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn(b_, n, 3, nh, hd, generator=gen, device=device).to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in proj.unbind(2))
    q = (q * hd ** -0.5).contiguous()
    tau = (0.1 + 0.9 * torch.rand(nh, n, n, generator=gen, device=device)).clamp_min(0.01)
    bias = 2.0 * torch.randn(nh, n, n, generator=gen, device=device)
    mask = None
    if nw > 1:
        w = int(round(n ** 0.5))
        res = w * int(round(nw ** 0.5))
        mask = torch.from_numpy(_shift_attn_mask(res, res, w, w // 2)).to(device)
    return q, k, v, tau, bias, mask


def measure(shape, iters, sweep, device):
    b_, nh, n, hd, nw, launches = shape
    args = operands(b_, nh, n, hd, nw, device, b_ * 100 + nh + n + nw)
    with torch.inference_mode():
        fn = lambda: k2.swin_window_attention(*args)
        ms = events_ms(fn, iters)
        graph = graph_ms(fn, iters)
        host = host_us(fn, iters)
        grids = grid_split(fn, iters)
        swept = {}
        if sweep:
            dims = k2._check_kernel_args(*args)
            for wpb in range(1, min(k2.MAX_WINDOWS_PER_BLOCK, b_ // nw) + 1):
                swept[wpb] = graph_ms(
                    lambda: k2._run("window_attention_mma", dims, *args, wpb), iters)
    bms, bound_by, nbytes = bound_ms(b_, nh, n, hd, nw)
    row = dict(windows=b_, heads=nh, tokens=n, head_dim=hd, mask_windows=nw, launches=launches,
               ms=ms, graph_ms=graph, host_us=host, grids=grids, bound_ms=bms,
               bound_by=bound_by, gb_s=nbytes / graph / 1e6)
    if sweep:
        row["plan"] = k2.plan(b_, nh, n, hd, nw).windows_per_block
        row["sweep_graph_ms"] = swept
    return row


def forward(image, window, iters, device):
    """img/s, busy ms, idle share and K2's busy ms of the served B=8
    swin_unet_v2 forward on the kernel path."""
    model = create_model("swin_unet_v2", dtype=torch.bfloat16, device=device, seed=0,
                         image_size=image, window_size=window)
    predict = make_predictor(model, None, "logits")
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(BATCH, 3, image, image, generator=gen, device=device)
    with torch.inference_mode():
        for _ in range(3):
            predict(x)
        samples = [events_ms(lambda: predict(x), 3) for _ in range(10)]
        grids = grid_split(lambda: predict(x), 3)
    med = statistics.median(samples)
    busy = sum(ms for ms, _ in grids.values())
    ours = {k: v for k, v in grids.items() if K2_GRID in k}
    k2_ms = sum(ms for ms, _ in ours.values())
    return dict(image=image, window=window, img_per_s=BATCH / (med / 1e3), forward_ms=med,
                samples_ms=samples, busy_ms=busy, idle_share=1 - busy / med, k2_busy_ms=k2_ms,
                k2_share_of_busy=k2_ms / busy, k2_grids=ours)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times K2 on the card")
    device = torch.device("cuda")
    print(f"K2 on {torch.cuda.get_device_name(0)}, package {unet_zoo_tpu_torch.__file__}",
          flush=True)
    out = {"package": unet_zoo_tpu_torch.__file__, "device": torch.cuda.get_device_name(0)}
    for image, window in CONFIGS:
        key = f"{image}px"
        rows = []
        for shape in k2.launch_shapes(image, window, BATCH):
            row = measure(shape, args.iters, args.sweep, device)
            rows.append(row)
            parts = ", ".join(f"{k} {ms:.4f} ms x{cnt:g}" for k, (ms, cnt) in row["grids"].items())
            sweep = ""
            if args.sweep:
                sweep = f"; plan {row['plan']}, by windows a block " + ", ".join(
                    f"{w}: {ms:.4f}" for w, ms in row["sweep_graph_ms"].items())
            print(f"K2 {key} B_={shape[0]} nh={shape[1]} N={shape[2]} nW={shape[4]} "
                  f"x{shape[5]}: {row['ms']:.4f} ms by events, {row['graph_ms']:.4f} ms by graph, "
                  f"host {row['host_us']:.1f} us a call, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']}), {row['gb_s']:.1f} GB/s; device {parts}{sweep}", flush=True)
        per = lambda k: sum(r[k] * r["launches"] for r in rows)
        device_ms = sum(ms * r["launches"] for r in rows for ms, _ in r["grids"].values())
        print(f"per {key} forward: {per('ms'):.4f} ms by events, {per('graph_ms'):.4f} ms by "
              f"graph, {device_ms:.4f} ms device, host {per('host_us'):.1f} us, bound "
              f"{per('bound_ms'):.4f} ms", flush=True)
        out[key] = {"shapes": rows, "per_forward_ms": per("ms"), "per_forward_host_us": per("host_us"),
                    "per_forward_graph_ms": per("graph_ms"), "per_forward_device_ms": device_ms,
                    "per_forward_bound_ms": per("bound_ms")}
    if args.forward:
        for image, window in CONFIGS:
            out[f"{image}px"]["forward"] = fwd = forward(image, window, args.iters, device)
            print(f"swin_unet_v2 B={BATCH} {image}px window {window} kernel path: "
                  f"{fwd['img_per_s']:.1f} img/s (forward {fwd['forward_ms']:.4f} ms), busy "
                  f"{fwd['busy_ms']:.4f} ms, idle share {fwd['idle_share']:.3f}, K2 "
                  f"{fwd['k2_busy_ms']:.4f} ms ({fwd['k2_share_of_busy']:.3f} of busy)", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
