"""Export a trained checkpoint as a ``torch.export`` serving program.

    python -m unet_zoo_tpu_torch.cli.export --model unet --checkpoint <ckpt_dir> \
        --batch 8 --image-size 256 --output mask --out unet_serve.pt2 [--device cuda|cpu]

Counterpart of ``scripts/export.py``: the program holds the (bf16-cast)
weights, the whole inference program and the hand-written kernels as ops
(``utils/serving.py::export_predictor``); a serving process runs it with
``unet_zoo_tpu_torch.utils.serving.load_predictor``, without the model code.
A program exported on the card runs there; the device defaults to CUDA and
the run raises without it.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (as written by training: {'variables': ...})")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--in-channels", type=int, default=3)
    ap.add_argument("--num-classes", type=int, default=1)
    ap.add_argument("--output", default="logits", choices=["logits", "probs", "mask"])
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--no-bf16", action="store_true", help="keep weights f32 in the program")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device the program runs on (default: cuda; raises without it)")
    args = ap.parse_args(argv)

    from unet_zoo_tpu_torch.models import create_model
    from unet_zoo_tpu_torch.utils.checkpoint import load_checkpoint
    from unet_zoo_tpu_torch.utils.serving import export_predictor

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    model = create_model(args.model, in_channels=args.in_channels,
                         num_classes=args.num_classes, image_size=args.image_size,
                         device=args.device)
    model.module.load_state_dict(load_checkpoint(args.checkpoint)["variables"], strict=True)
    blob = export_predictor(
        model, None, batch=args.batch, image_size=args.image_size,
        in_channels=args.in_channels, output=args.output, threshold=args.threshold,
        cast_bf16=not args.no_bf16, path=args.out)
    print(f"wrote {args.out}: {len(blob) / 1e6:.2f} MB "
          f"({args.model}, b{args.batch}@{args.image_size}px, {args.output})")


if __name__ == "__main__":
    main()
