"""Probe: does ``int8_gemm.conv_plan`` pick the fastest launch of P2's conv?

At each launch shape of one served forward of ``unet_tpu`` (bf16) and
``unet`` (float32) at B=8/256px, or of one of the names whose gated convs
are dilated or 1x1 (``u2net``, ``u2netp``, ``u2net_tpu``, ``resunet``,
``multiresunet``; bf16, shapes by :func:`traced_launch_shapes`, K = k^2 Ci),
the conv is timed on the card under every
block tile width BN the planner considers, each with no K split and with the
split the planner's model likes best for that BN (``int8_gemm.plan_cost``).
Each launch is first held against the plan's own choice bit for bit. The
times are by CUDA graph replay (``--reps`` launches a graph, three replays),
from a float x as a served conv sees it (a ReLU output).

Per row it prints the modelled cost and the measured ms per modelled stage
(ms over waves x (stages a block runs + 2)); at the end, per BN, the median
of that over the rows without a split, relative to BN = 64: the fit of
``int8_gemm.STAGE_COST``. It also prints, per shape, how much slower the
planner's choice is than the fastest launch measured.

Usage: python -m unet_zoo_tpu_torch.probes.int8_conv_plan [--model all|unet_tpu|unet|u2net|
       u2netp|u2net_tpu|resunet|multiresunet] [--batch 8] [--image 256] [--reps 20]
"""

from __future__ import annotations

import argparse
import statistics

import torch

from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2

UNET_TPU_WIDTHS = (128, 256, 512, 512)
TRACED = ("u2net", "u2netp", "u2net_tpu", "resunet", "multiresunet")


def launch_shapes(name, image=256, batch=8, widths=UNET_TPU_WIDTHS):
    """The int8 conv's launch shapes in one forward of ``name`` (unet 64 ->
    1024 channels; attention_unet at depth 5, 64 -> 1024, each decoder level
    a conv after the nearest 2x upsampling and a ConvBlock; transatt_unet,
    unet_transformer and da_transformer at registry widths; unet_tpu at
    ``widths``, the stem to image / 4): rows of (B, H, W, Ci, Co, stride, launches), H and W the
    conv's input, in the order of first launch."""
    convs = []
    if name == "attention_unet":
        chans, cin, size = (64, 128, 256, 512, 1024), 3, image
        for i, c in enumerate(chans):
            size = size // 2 if i else size
            convs += [(size, cin, c, 1), (size, c, c, 1)]
            cin = c
        for i in range(4, 0, -1):
            size *= 2
            c = chans[i - 1]
            convs += [(size, chans[i], c, 1), (size, 2 * c, c, 1), (size, c, c, 1)]
    elif name in ("transatt_unet", "unet_transformer"):
        # the encoder's double convs (transatt_unet: four Downs to 512, the
        # last keeping 512; unet_transformer: three), then each decoder level
        # from the concatenation (transatt_unet: to in // 2, then to half
        # that; unet_transformer: cross attention's 2 Cs to Cs, then Cs)
        chans = (64, 128, 256, 512, 512) if name == "transatt_unet" else (64, 128, 256, 512)
        cin, size = 3, image
        for i, c in enumerate(chans):
            size = size // 2 if i else size
            convs += [(size, cin, c, 1), (size, c, c, 1)]
            cin = c
        for i in range(len(chans) - 1, 0, -1):
            size *= 2
            c = chans[i - 1]
            if name == "transatt_unet":
                cat = c + cin
                convs += [(size, cat, cat // 2, 1), (size, cat // 2, cat // 4 if i > 1 else c, 1)]
                cin = cat // 4 if i > 1 else c
            else:
                convs += [(size, 2 * c, c, 1), (size, c, c, 1)]
    elif name == "da_transformer":
        # ResNetV2's root (7x7 stride-2 conv, 3x3 stride-2 max pool with no
        # padding: 63 x 63 from 256px) and its stride-2 stages give the skip
        # sizes; the bottleneck's double conv at 1024 channels, then each
        # UpSampleDA's double conv at the skip's size from the concatenation
        stem = ((image - 1) // 2 + 1 - 3) // 2 + 1
        e2 = (stem - 1) // 2 + 1
        e3 = (e2 - 1) // 2 + 1
        convs += [(e3, 1024, 1024, 1)] * 2
        for size, c in ((e3, 512), (e2, 256), (stem, 128), (stem, 64)):
            convs += [(size, 2 * c, c, 1), (size, c, c, 1)]
    elif name == "unet":
        chans, cin, size = (64, 128, 256, 512), 3, image
        for c in chans:
            convs += [(size, cin, c, 1), (size, c, c, 1)]
            cin, size = c, size // 2
        convs += [(size, 512, 1024, 1), (size, 1024, 1024, 1)]
        for c in reversed(chans):
            size *= 2
            convs += [(size, 2 * c, c, 1), (size, c, c, 1)]
    else:
        w, size = widths, image // 4
        for i in range(3):
            convs += [(size, w[i], w[i], 1)] * 2 + [(size, w[i], w[i + 1], 2)]
            size //= 2
        convs += [(size, w[3], w[3], 1)] * 2
        for i in (2, 1, 0):
            size *= 2
            convs += [(size, w[i + 1] + w[i], w[i], 1), (size, w[i], w[i], 1)]
    counts = {}
    for c in convs:
        counts[c] = counts.get(c, 0) + 1
    return [(batch, s, s, ci, co, st, n) for (s, ci, co, st), n in counts.items()]


def traced_launch_shapes(name, image=256, batch=8, **kw):
    """The int8 conv's launches in one forward of the registry model
    ``name`` (``kw`` to ``create_model``), read off the model itself: its
    float forward runs on the meta device (no data, no arithmetic) with
    every int8-gated conv recorded. Rows of (B, H, W, Ci, Co, stride,
    launches, ksize, padding, dilation), H and W the conv's input, in the
    order of first launch; for the names whose gated convs are not all 3x3
    convs with padding 1 (u2net's and u2net_tpu's dilated ones, resunet's
    and multiresunet's 1x1 ones), where a hand count would miss one."""
    from unet_zoo_tpu_torch.models import _REGISTRY
    from unet_zoo_tpu_torch.nn import blocks

    spec = _REGISTRY[name]
    with torch.device("meta"):   # no weights drawn
        net = spec.build(in_channels=3, num_classes=1, image_size=spec.default_image_size,
                         depth=5, dtype=torch.float32, use_kernels=False, **kw).eval()
    gated, counts = blocks.gated_conv, {}

    def recording(x, conv_m, dtype, use_kernels=None):
        row = (batch, x.shape[2], x.shape[3], x.shape[1], conv_m.out_channels,
               conv_m.stride[0], conv_m.kernel_size[0], conv_m.padding[0], conv_m.dilation[0])
        counts[row] = counts.get(row, 0) + 1
        return gated(x, conv_m, dtype, use_kernels)

    blocks.gated_conv = recording
    try:
        with torch.no_grad():
            net(torch.empty(batch, 3, image, image, device="meta"))
    finally:
        blocks.gated_conv = gated
    return [(*row[:6], n, *row[6:]) for row, n in counts.items()]


def graph_ms(fn, reps):
    """Mean device ms of ``fn()`` over ``reps`` calls captured in one CUDA
    graph, replayed three times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def candidates(m, co, kpad):
    """(BN, splits) of every launch timed at one shape: per BN the planner
    considers, no split (where that fills the card) and its best split."""
    stages = -(-kpad // p2.K_STAGE)
    out = []
    for bn in p2.TILE_N:
        costs = {z: p2.plan_cost(m, co, kpad, bn, z) for z in range(1, stages + 1)}
        costs = {z: c for z, c in costs.items() if c is not None}
        if not costs:
            continue
        best = min(costs, key=lambda z: (costs[z], z))
        out += [(bn, z) for z in sorted({min(costs), best})]
    return out


def stage_units(m, co, kpad, bn, splits):
    """Waves of one block per SM times (the stages a block runs + 2)."""
    stages = -(-kpad // p2.K_STAGE)
    blocks = -(-m // p2.BM) * -(-co // bn) * splits
    return -(-blocks // p2.SMS) * (-(-stages // splits) + 2)


def run(models, batch, image, reps, device):
    rows = []
    for name in models:
        dtype = torch.float32 if name == "unet" else torch.bfloat16
        gen = torch.Generator(device=device).manual_seed(0)
        shapes = (traced_launch_shapes(name, image, batch) if name in TRACED
                  else [(*r, 3, 1, 1) for r in launch_shapes(name, image, batch)])
        for b, h, w, ci, co, stride, _, *geometry in shapes:
            x = torch.relu(torch.randn(b, h, w, ci, generator=gen, device=device)).to(dtype)
            s_x = (x.float().abs().amax() / 127).reshape(())
            k = geometry[0]
            wq = torch.randint(-127, 128, (co, ci, k, k), generator=gen, device=device,
                               dtype=torch.int8)
            wp = p2.pack_conv_weight(wq)
            scale = 1e-4 * (0.5 + torch.rand(co, generator=gen, device=device))
            bias = 0.1 * torch.randn(co, generator=gen, device=device)
            m = b * p2.conv_out_size(h, stride, *geometry) * p2.conv_out_size(w, stride,
                                                                               *geometry)
            kpad = wp.shape[1]
            chosen = p2.conv_plan(m, co, kpad)
            want = p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype, *geometry)
            times = {}
            for bn, splits in candidates(m, co, kpad):
                plan = (p2.BM, bn, splits)
                got = p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype, *geometry,
                                      plan=plan)
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {b, h, w, ci, co, stride, *geometry}: plan "
                                         f"{plan} disagrees with {chosen}")
                ms = graph_ms(lambda: p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype,
                                                      *geometry, plan=plan), reps)
                units = stage_units(m, co, kpad, bn, splits)
                times[bn, splits] = ms
                rows.append(dict(model=name, shape=(b, h, w, ci, co, stride, *geometry), bn=bn,
                                 splits=splits, cost=p2.plan_cost(m, co, kpad, bn, splits),
                                 ms=ms, ms_per_unit=ms / units, chosen=plan == chosen))
                print(f"{name} [{b}, {h}, {w}, {ci}] -> {co} s{stride} {tuple(geometry)}: BN {bn} "
                      f"split {splits}{' (conv_plan)' if plan == chosen else ''}: {ms:.4f} ms, "
                      f"modelled "
                      f"{rows[-1]['cost']:.2f}, {1e3 * ms / units:.3f} us per stage unit",
                      flush=True)
            fastest = min(times, key=times.get)
            print(f"{name} [{b}, {h}, {w}, {ci}] -> {co} s{stride} {tuple(geometry)}: conv_plan "
                  f"BN {chosen[1]} split {chosen[2]} is "
                  f"{times[chosen[1:]] / times[fastest]:.3f}x the fastest "
                  f"(BN {fastest[0]} split {fastest[1]}, {times[fastest]:.4f} ms)", flush=True)
    per_bn = {bn: [r["ms_per_unit"] for r in rows if r["bn"] == bn and r["splits"] == 1]
              for bn in p2.TILE_N}
    med = {bn: statistics.median(v) for bn, v in per_bn.items() if v}
    if p2.TILE_N[0] in med:
        fit = {bn: round(v / med[p2.TILE_N[0]], 3) for bn, v in med.items()}
        print(f"stage time by BN relative to BN {p2.TILE_N[0]} (median over unsplit launches): "
              f"{fit}; STAGE_COST {p2.STAGE_COST}", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="all", choices=["all", "unet_tpu", "unet", *TRACED])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe times the conv kernel on the card")
    models = ("unet_tpu", "unet") if args.model == "all" else (args.model,)
    print(f"P2 conv plans on {torch.cuda.get_device_name(0)}", flush=True)
    run(models, args.batch, args.image, args.reps, torch.device("cuda"))


if __name__ == "__main__":
    main()
