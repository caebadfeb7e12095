"""Inference CLI: a checkpoint's predicted masks for an image or a folder.

    python -m unet_zoo_tpu_torch.cli.predict --model unet --checkpoint runs/ckpt/unet_best \
        --input data/test/images --output preds/ [--image-size 256]
        [--output-kind mask|probs|logits] [--tiled --tile 512 --overlap 0.25]
        [--batch 8] [--tta] [--int8] [--export unet.pt2] [--params '{...}']
        [--device cuda|cpu]

Counterpart of ``scripts/predict.py``, flag for flag, on the port's serving
functions (``utils/serving.py``) and checkpoints (``utils/checkpoint.py``):

* fixed size: images resized to ``--image-size``, run ``--batch`` at a time
  (a short last batch padded with copies of its first image), masks written
  as PNGs resized back to each input's size (nearest), probabilities and
  logits as ``.npy`` at the model's size;
* ``--tiled``: native resolution through the sliding-window predictor
  (``make_tiled_predictor``, Hann-blended overlaps), ``.npy`` for probs and
  logits;
* ``--int8``: int8 convs calibrated on the first image, quantised from the
  float32 weights (no bf16 cast, as the JAX script does);
* ``--tta``: flip test-time augmentation, on the fixed-size path and for
  masks or probabilities only;
* ``--export``: also write the predictor as a ``torch.export`` program
  (``export_predictor``; ``load_predictor`` runs it without the model code).

The device defaults to CUDA and the run raises without it; ``--device cpu``
runs on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from unet_zoo_tpu_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(
        description="Run a trained UNet Zoo checkpoint on images (PyTorch port).")
    p.add_argument("--model", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir written by the training loop (arrays.pt)")
    p.add_argument("--input", required=True, help="an image file or a directory of images")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--in-channels", type=int, default=3)
    p.add_argument("--num-classes", type=int, default=1)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--output-kind", default="mask", choices=["mask", "probs", "logits"])
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--tiled", action="store_true",
                   help="native-resolution sliding-window inference "
                        "(no resize; images larger than --image-size)")
    p.add_argument("--tile", type=int, default=None,
                   help="tile size for --tiled (default: --image-size)")
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--tta", action="store_true",
                   help="flip test-time augmentation: average probabilities over the 4 "
                        "H/V-flip variants (fixed-size path, mask/probs outputs)")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 calibration on the first batch")
    p.add_argument("--export", default=None, metavar="PATH",
                   help="also write the predictor as a torch.export program")
    p.add_argument("--params", default=None, help="JSON dict of extra create_model kwargs")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to serve on (default: cuda; raises without it)")
    return p.parse_args(argv)


def list_images(path: str):
    if os.path.isfile(path):
        return [path]
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith(_EXTS))
    if not files:
        raise SystemExit(f"No images found under {path}")
    return files


def load_image(path: str, size, in_channels: int):
    """-> (normalised float32 HWC array, original (W, H))."""
    from PIL import Image

    img = Image.open(path).convert("RGB" if in_channels == 3 else "L")
    orig = img.size
    if size is not None:
        img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    if in_channels == 3:
        arr = (arr - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    else:
        arr = (arr - 0.5) / 0.5
    return arr.astype(np.float32), orig


def to_batch(arrays) -> torch.Tensor:
    """HWC arrays -> an NCHW float32 batch."""
    return torch.from_numpy(np.stack(arrays)).permute(0, 3, 1, 2).contiguous()


def save_output(arr: np.ndarray, kind: str, path: str, orig_size=None):
    """Write one HWK prediction. Masks go out as PNG at the original size
    (nearest); probs/logits as .npy at the served size."""
    if kind == "mask":
        from PIL import Image

        img = Image.fromarray((np.asarray(arr)[..., 0] * 255).astype(np.uint8), mode="L")
        if orig_size is not None and img.size != orig_size:
            img = img.resize(orig_size, Image.NEAREST)
        img.save(path + ".png")
    else:
        np.save(path + ".npy", np.asarray(arr, np.float32))


def build_model(args):
    """The registry model on the chosen device with the checkpoint's weights."""
    from unet_zoo_tpu_torch.models import create_model
    from unet_zoo_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    if not checkpoint_exists(args.checkpoint):
        raise SystemExit(f"Checkpoint not found: {args.checkpoint}")
    params = json.loads(args.params) if args.params else {}
    params.setdefault("in_channels", args.in_channels)
    params.setdefault("num_classes", args.num_classes)
    params.setdefault("image_size", args.image_size)
    model = create_model(args.model, device=args.device, **params)
    variables = load_checkpoint(args.checkpoint).get("variables")
    if variables is None:
        raise SystemExit(f"{args.checkpoint} has no 'variables' payload: is this a training "
                         "checkpoint from unet_zoo_tpu_torch.cli.train?")
    model.module.load_state_dict(variables, strict=True)
    return model


def main(argv=None):
    args = parse_arguments(argv)
    from unet_zoo_tpu_torch.utils import serving

    model = build_model(args)
    files = list_images(args.input)
    os.makedirs(args.output, exist_ok=True)
    print(f"{args.model}: {len(files)} image(s) -> {args.output} "
          f"({'tiled ' if args.tiled else ''}{args.output_kind})")

    cast_bf16, quant = True, None
    if args.int8:
        x0, _ = load_image(files[0], args.image_size, args.in_channels)
        quant = serving.calibrate_int8(model, [to_batch([x0])])
        cast_bf16 = False  # quantise from the float32 weights (README int8 recipe)
        print("int8: calibrated on 1 batch")

    if args.export:
        serving.export_predictor(
            model, None, batch=args.batch, image_size=args.image_size,
            in_channels=args.in_channels, output=args.output_kind, threshold=args.threshold,
            cast_bf16=cast_bf16, quant=quant, path=args.export)
        print(f"export: torch.export program -> {args.export} "
              f"(batch {args.batch}, {args.image_size}px)")

    if args.tta and (args.tiled or args.output_kind == "logits"):
        raise SystemExit("--tta averages probabilities on the fixed-size path: use without "
                         "--tiled and with --output-kind mask|probs")
    stem = lambda f: os.path.splitext(os.path.basename(f))[0]
    host = lambda t: t.float().permute(0, 2, 3, 1).cpu().numpy()
    if args.tiled:
        predict = serving.make_tiled_predictor(
            model, None, tile=args.tile or args.image_size, overlap=args.overlap,
            output=args.output_kind, threshold=args.threshold, cast_bf16=cast_bf16,
            quant=quant)
        for f in files:
            arr, _ = load_image(f, None, args.in_channels)
            out = host(predict(to_batch([arr])))[0]
            save_output(out, args.output_kind, os.path.join(args.output, stem(f)))
            print(f"  {stem(f)}: {arr.shape[0]}x{arr.shape[1]} done")
        return

    predict = serving.make_predictor(model, None, output=args.output_kind,
                                     threshold=args.threshold, cast_bf16=cast_bf16,
                                     tta=args.tta, quant=quant)
    b = args.batch
    for i in range(0, len(files), b):
        chunk = files[i:i + b]
        imgs, origs = zip(*(load_image(f, args.image_size, args.in_channels) for f in chunk))
        imgs = list(imgs) + [imgs[0]] * (b - len(chunk))  # pad to the batch; drop the pad rows
        out = host(predict(to_batch(imgs)))[:len(chunk)]
        for j, f in enumerate(chunk):
            save_output(out[j], args.output_kind, os.path.join(args.output, stem(f)), origs[j])
        print(f"  [{min(i + b, len(files))}/{len(files)}]")


if __name__ == "__main__":
    main()
