"""Probe: K6's time at each launch shape of the B=8 ``gated`` forward (s =
0.125, groups 8, 256px), both axes, and the forward itself.

For every (L = H = W, gp, ks) launch shape of the forward (``SHAPES``, with
the number of AxialBlocks of that shape; each runs K6 along H and along W),
the probe folds a seeded random ``gated`` AxialAttention (BN statistics and
affines off identity, bf16 parameters, as chip_smoke.py's ``time_k6``),
draws a seeded bf16 qkv and reads:

- ``ms``: one ``fused_axial_attention`` call, CUDA events around ``--iters``
  back-to-back calls; ``graph_ms``: the same calls captured in one CUDA
  graph and replayed, the device time without the wrapper's host cost;
  ``host_us``: their difference, the wrapper's cost a call where it exceeds
  the device time;
- ``grids``: each grid's device time per call by kernel name, from
  ``torch.profiler`` (the fuller of two traces), with its launches per call;
- ``bound_ms``: 6c + 4gp + 5 f32 operations per (row, group, query, key)
  at 67 TFLOP/s (chip_smoke.py's ``axial_work``).

With ``--forward`` it also serves ``gated`` (bf16, seeded random weights,
kernel path) at B=8/256px and reads img/s (median of 10 samples of 3
forwards, by CUDA events), the device's busy time per forward from the
profiler, the idle share, and K6's share of the busy time.

It prints one line per reading and a JSON line with every reading. It
imports the port package found first on the path, so it reads another
checkout of the port when run as a file with that checkout first on
``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/axial_grids.py

Usage: python -m unet_zoo_tpu_torch.probes.axial_grids [--iters 20] [--forward]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.medt_net import AxialAttention
from unet_zoo_tpu_torch.nn import init_weights
from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6
from unet_zoo_tpu_torch.probes.mkblock_grids import events_ms, graph_ms, grid_split
from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference, make_predictor

BATCH = 8
IMAGE = 256
GROUPS = 8
PEAK_F32_FLOPS = 67e12   # H100 SXM float32 outside the tensor cores
# gated at 256px: (L = H = W, gp, kernel size, AxialBlocks of that shape)
SHAPES = [(128, 2, 128, 1), (128, 4, 128, 1), (64, 4, 64, 1), (64, 8, 64, 1),
          (32, 8, 32, 3), (32, 16, 32, 1)]
K6_GRID = "axial_attention_kernel"   # in the name of every K6 grid


def folded_tables(gp, ks, width_axis, device, seed):
    """The folded tables of a seeded bf16 eval ``gated`` AxialAttention."""
    attn = AxialAttention(GROUPS * gp, GROUPS * gp, GROUPS, ks, width_axis=width_axis,
                          mode="gated", dtype=torch.bfloat16, use_kernels=False)
    g = torch.Generator().manual_seed(seed)
    init_weights(attn, g)
    with torch.no_grad():
        for m in attn.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
    w = k6.fold_axial_params(cast_params_for_inference(attn).to(device).eval())
    return w.relative, w.sim_scale, w.out_scale, w.out_shift


def f32_ops(n, length, gp):
    return n * GROUPS * length * length * (6 * (gp // 2) + 4 * gp + 5)


def measure(s, gp, ks, width_axis, iters, device):
    tables = folded_tables(gp, ks, width_axis, device, s + gp)
    gen = torch.Generator(device=device).manual_seed(s * 100 + gp * 10 + width_axis)
    qkv = torch.randn(BATCH, 2 * GROUPS * gp, s, s, generator=gen, device=device)
    qkv = qkv.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        fn = lambda: k6.fused_axial_attention(qkv, *tables, ks, width_axis)
        ms = events_ms(fn, iters)
        graph = graph_ms(fn, iters)
        grids = grid_split(fn, iters)
    return dict(qkv=[BATCH, 2 * GROUPS * gp, s, s], axis="W" if width_axis else "H", gp=gp,
                length=s, ms=ms, graph_ms=graph, host_us=1e3 * (ms - graph), grids=grids,
                bound_ms=1e3 * f32_ops(BATCH * s, s, gp) / PEAK_F32_FLOPS)


def forward(iters, device):
    """img/s, busy ms, idle share and K6's busy ms of the served B=8/256px
    gated forward on the kernel path."""
    model = create_model("gated", dtype=torch.bfloat16, device=device, seed=0,
                         image_size=IMAGE)
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
    ours = {k: v for k, v in grids.items() if K6_GRID in k}
    k6_ms = sum(ms for ms, _ in ours.values())
    return dict(img_per_s=BATCH / (med / 1e3), forward_ms=med, samples_ms=samples,
                busy_ms=busy, idle_share=1 - busy / med, k6_busy_ms=k6_ms,
                k6_share_of_busy=k6_ms / busy, k6_grids=ours)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times K6 on the card")
    device = torch.device("cuda")
    print(f"K6 on {torch.cuda.get_device_name(0)}, package {unet_zoo_tpu_torch.__file__}",
          flush=True)
    rows = []
    for s, gp, ks, n in SHAPES:
        for width_axis in (False, True):
            row = measure(s, gp, ks, width_axis, args.iters, device)
            row["launches"] = n
            rows.append(row)
            parts = ", ".join(f"{k} {ms:.4f} ms x{cnt:g}" for k, (ms, cnt) in row["grids"].items())
            print(f"K6 qkv={row['qkv']} along {row['axis']} x{n}: {row['ms']:.4f} ms by events, "
                  f"{row['graph_ms']:.4f} ms by graph, host {row['host_us']:.1f} us a call, "
                  f"bound {row['bound_ms']:.4f} ms; device {parts}", flush=True)
    per = lambda key: sum(r[key] * r["launches"] for r in rows)
    device_ms = sum(ms * r["launches"] for r in rows for ms, _ in r["grids"].values())
    print(f"per forward: {per('ms'):.4f} ms by events, {per('graph_ms'):.4f} ms by graph, "
          f"{device_ms:.4f} ms device, bound {per('bound_ms'):.4f} ms", flush=True)
    out = {"package": unet_zoo_tpu_torch.__file__, "device": torch.cuda.get_device_name(0),
           "shapes": rows, "per_forward_ms": per("ms"), "per_forward_graph_ms": per("graph_ms"),
           "per_forward_device_ms": device_ms, "per_forward_bound_ms": per("bound_ms")}
    if args.forward:
        out["forward"] = fwd = forward(args.iters, device)
        print(f"gated B={BATCH} {IMAGE}px kernel path: {fwd['img_per_s']:.1f} img/s (forward "
              f"{fwd['forward_ms']:.4f} ms), busy {fwd['busy_ms']:.4f} ms, idle share "
              f"{fwd['idle_share']:.3f}, K6 {fwd['k6_busy_ms']:.4f} ms "
              f"({fwd['k6_share_of_busy']:.3f} of busy)", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
