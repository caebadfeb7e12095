"""Probe: K8's device time at each launch shape of the B=8 ``wranet`` forward
(feature_channels 128, 256px), under several offset regimes, and the forward
itself.

For both launch shapes (x [8, 128, 128, 128] and [8, 256, 256, 128], O 32,
3x3 taps) the probe reads K8 on seeded bf16 operands with offsets of std 0
(the registry's init), 1, 3 and 8 pixels (sigmoid masks), and on the served
model's own operands (``served``: the bf16 ``wranet`` at B=8/256px, seed 0,
its offset and modulator convs drawn off zero by ``models/wranet.py::draw_offsets``):

- ``ms``: one ``deform_conv2d`` call, CUDA events around ``--iters``
  back-to-back calls; ``graph_ms``: the same calls captured in one CUDA
  graph and replayed, the device time without the wrapper's host cost.

With ``--forward`` it serves ``wranet`` on the kernel path at B=8/256px and
reads img/s (median of 10 samples of 3 forwards, by CUDA events), the
device's busy time per forward from the profiler, the idle share, and K8's
share of the busy time.

It prints one line per reading and a JSON line with every reading. It
imports the port package found first on the path, so it reads another
checkout of the port (one whose ``models/wranet.py`` has ``draw_offsets``)
when run as a file with that checkout first on ``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/deform_grids.py

Usage: python -m unet_zoo_tpu_torch.probes.deform_grids [--iters 20] [--forward]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.wranet import draw_offsets
from unet_zoo_tpu_torch.ops.kernels import deform as k8
from unet_zoo_tpu_torch.probes.mkblock_grids import events_ms, graph_ms, grid_split
from unet_zoo_tpu_torch.utils.serving import make_predictor

BATCH = 8
IMAGE = 256
FEATURES = 128      # wranet's feature_channels; K8 takes C 128 -> O 32
# (B, H, W, C, O) of K8's two launches: decoder_lv2 at 128px, decoder_lv1 at 256px
SHAPES = [(BATCH, IMAGE // 2, IMAGE // 2, FEATURES, FEATURES // 4),
          (BATCH, IMAGE, IMAGE, FEATURES, FEATURES // 4)]
# seeded offsets: std in pixels
REGIMES = {"zero": 0.0, "std1": 1.0, "std3": 3.0, "std8": 8.0}
# the served model's offset and modulator convs: std = scale / sqrt(fan_in)
OFFSET_SCALE, MASK_SCALE, OFFSET_SEED = 2.0, 1.5, 13


def seeded_case(b, h, w, c, o, scale, device):
    """bf16 K8 operands: offsets of std ``scale`` pixels, sigmoid masks, a
    weight of O(1) outputs."""
    gen = torch.Generator(device=device).manual_seed(1000 * h + int(10 * scale))
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    bf = torch.bfloat16
    return (r(b, h, w, c).to(bf), (scale * r(b, h, w, 18)).to(bf),
            torch.sigmoid(2.0 * r(b, h, w, 9)).to(bf), (r(3, 3, c, o) / (9 * c) ** 0.5).to(bf),
            r(o).to(bf))


def served_model(device):
    model = create_model("wranet", dtype=torch.bfloat16, device=device, seed=0,
                         feature_channels=FEATURES)
    draw_offsets(model.module, OFFSET_SCALE, MASK_SCALE, OFFSET_SEED)
    predict = make_predictor(model, None, "logits")
    gen = torch.Generator(device=device).manual_seed(1)
    return predict, torch.randn(BATCH, 3, IMAGE, IMAGE, generator=gen, device=device)


def served_operands(device):
    """The operands of K8's two launches in one served forward, in launch
    order (128px, then 256px)."""
    predict, x = served_model(device)
    seen, real = [], k8.deform_conv2d

    def record(*args):
        seen.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    k8.deform_conv2d = record
    try:
        with torch.inference_mode():
            predict(x)
    finally:
        k8.deform_conv2d = real
    return seen


def timed(fn, iters):
    with torch.inference_mode():
        return events_ms(fn, iters), graph_ms(fn, iters)


def offset_spread(args):
    """Share of samples whose offset exceeds 1, 3 and 8 pixels on an axis."""
    off = args[1].float()
    return {f">{t}px": (off.abs() > t).float().mean().item() for t in (1, 3, 8)}


def measure(iters, device):
    rows = []
    operands = {name: [seeded_case(*shape, scale, device) for shape in SHAPES]
                for name, scale in REGIMES.items()}
    operands["served"] = served_operands(device)
    for name, cases in operands.items():
        for shape, args in zip(SHAPES, cases):
            ms, graph = timed(lambda: k8.deform_conv2d(*args), iters)
            rows.append(dict(regime=name, shape=list(shape), ms=ms, graph_ms=graph,
                             offsets=offset_spread(args)))
            print(f"K8 {name} x={list(shape)}: {ms:.4f} ms by events, {graph:.4f} ms by graph; "
                  f"offsets {rows[-1]['offsets']}", flush=True)
    return rows, operands


def forward(iters, device):
    """img/s, busy ms, idle share and K8's busy ms of the served B=8/256px
    wranet forward on the kernel path."""
    predict, x = served_model(device)
    with torch.inference_mode():
        for _ in range(3):
            predict(x)
        samples = [events_ms(lambda: predict(x), 3) for _ in range(10)]
        grids = grid_split(lambda: predict(x), 3)
    med = statistics.median(samples)
    busy = sum(ms for ms, _ in grids.values())
    ours = {k: v for k, v in grids.items() if "deform_kernel" in k}
    return dict(img_per_s=BATCH / (med / 1e3), forward_ms=med, samples_ms=samples,
                busy_ms=busy, idle_share=1 - busy / med,
                k8_busy_ms=sum(ms for ms, _ in ours.values()), k8_grids=ours,
                top=sorted(grids.items(), key=lambda kv: -kv[1][0])[:8])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times K8 on the card")
    device = torch.device("cuda")
    print(f"K8 on {torch.cuda.get_device_name(0)}, package {unet_zoo_tpu_torch.__file__}",
          flush=True)
    rows, operands = measure(args.iters, device)
    out = {"package": unet_zoo_tpu_torch.__file__, "shapes": rows}
    for name in operands:
        mine = [r for r in rows if r["regime"] == name]
        out[f"per_forward_{name}"] = fwd = dict(ms=sum(r["ms"] for r in mine),
                                                graph_ms=sum(r["graph_ms"] for r in mine))
        print(f"per forward, {name}: {fwd['ms']:.4f} ms by events, {fwd['graph_ms']:.4f} ms "
              f"by graph", flush=True)
    if args.forward:
        out["forward"] = fwd = forward(args.iters, device)
        print(f"wranet B={BATCH} {IMAGE}px kernel path: {fwd['img_per_s']:.1f} img/s "
              f"(forward {fwd['forward_ms']:.4f} ms), busy {fwd['busy_ms']:.4f} ms, idle "
              f"share {fwd['idle_share']:.3f}, K8 {fwd['k8_busy_ms']:.4f} ms; top grids "
              f"{[(k, round(v[0], 4)) for k, v in fwd['top']]}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
