"""Probe: how far apart do the MedT kernel and plain paths lie, input by input?

``chip_smoke.py`` serves each 128px MedT name once on one seeded input and
holds the bf16 kernel path (K6) to the bf16 plain path: mask agreement at
least ``--agree``, and the kernel path's relative L2 distance to float32
compute at most ``--ratio`` times the plain path's. Random-weight MedT logits
amplify rounding, so those readings move from input to input. This probe
draws ``--inputs`` seeded inputs and prints, per name, the spread of each
reading, how many inputs miss each bar, and the masks' agreement of each bf16
path with float32 compute (which of the two lies closer).

Usage: python -m unet_zoo_tpu_torch.probes.medt_paths [--names axialunet medt logo medt_logo]
       [--inputs 32] [--batch 2] [--image 128] [--agree 0.99] [--ratio 1.25]
"""

from __future__ import annotations

import argparse
import statistics

import torch

from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.utils.serving import make_predictor


def readings(name, inputs, batch, image, device):
    """Per input: mask agreement kernel/plain, kernel/f32, plain/f32, the
    ratio of the kernel path's distance to f32 compute over the plain path's,
    and the kernel path's relative L2 distance to the plain path."""
    build = lambda **kw: make_predictor(create_model(name, seed=0, image_size=image, **kw),
                                        None, "logits")
    kern = build(dtype=torch.bfloat16)
    plain = build(dtype=torch.bfloat16, use_kernels=False)
    exact = build(use_kernels=False)
    agree = lambda a, b: ((a > 0) == (b > 0)).float().mean().item()
    dist = lambda a, f: ((a - f).norm() / f.norm()).item()
    out = []
    for s in range(inputs):
        gen = torch.Generator(device=device).manual_seed(s)
        x = torch.randn(batch, 3, image, image, generator=gen, device=device)
        lk, lp, lf = kern(x).float(), plain(x).float(), exact(x).float()
        out.append(dict(kp=agree(lk, lp), kf=agree(lk, lf), pf=agree(lp, lf),
                        ratio=dist(lk, lf) / dist(lp, lf), rel=dist(lk, lp)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--names", nargs="+", default=["axialunet", "medt", "logo", "medt_logo"])
    ap.add_argument("--inputs", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--image", type=int, default=128)
    ap.add_argument("--agree", type=float, default=0.99)
    ap.add_argument("--ratio", type=float, default=1.25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe compares the paths on the card")
    device = torch.device("cuda")
    print(f"MedT paths on {torch.cuda.get_device_name(0)}, {args.inputs} inputs of "
          f"[{args.batch}, 3, {args.image}, {args.image}]", flush=True)
    for name in args.names:
        rows = readings(name, args.inputs, args.batch, args.image, device)
        col = lambda k: [r[k] for r in rows]
        kp, ratio = col("kp"), col("ratio")
        print(f"{name}: masks kernel/plain mean {statistics.mean(kp):.5f} "
              f"({min(kp):.5f}-{max(kp):.5f}, {sum(v < args.agree for v in kp)} inputs under "
              f"{args.agree}); kernel/f32 {statistics.mean(col('kf')):.5f}, plain/f32 "
              f"{statistics.mean(col('pf')):.5f}; distance to f32 kernel/plain median "
              f"{statistics.median(ratio):.3f} ({min(ratio):.3f}-{max(ratio):.3f}, "
              f"{sum(v > args.ratio for v in ratio)} inputs over {args.ratio})", flush=True)


if __name__ == "__main__":
    main()
