"""Probe: how far does K7 move one bf16 ``gated`` train step, batch by batch?

At random weights a bf16 ``gated`` train step turns rounding into loss: two
bf16 paths that agree launch by launch can read losses a few percent apart
on one batch. This probe takes one step from the same seeded weights on
``--batches`` seeded batches through four paths:

- kernel: the bf16 train kernel path (K7 on every axis pass);
- k7_plain: the same path with K7 swapped for its plain version,
  ``fused_axial_train_reference``, on the same device;
- module: the bf16 module path (``use_kernels=False``);
- f32: float32 compute on the module path;

and prints each batch's losses, then the medians of the kernel path's
relative loss difference against each other path, of the cosine between its
whole gradient and each other path's, and of k7_plain's relative loss
difference against module (two bf16 paths without the kernel).

It imports the port package found first on the path, so it reads another
checkout of the port when run as a file with that checkout first on
``PYTHONPATH``::

    PYTHONPATH=<checkout> python unet_zoo_tpu_torch/probes/gated_step.py

Usage: python -m unet_zoo_tpu_torch.probes.gated_step [--batches 16]
"""

from __future__ import annotations

import argparse
import statistics

import torch

import unet_zoo_tpu_torch
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
from unet_zoo_tpu_torch.train import create_train_state, make_train_step

PATHS = ("kernel", "k7_plain", "module", "f32")
BATCH, IMAGE = 2, 64      # the card test's step: 64px, B = 2


def batch_of(seed):
    """Seeded uint8 images and a random 0/1 mask, as a loader hands them over."""
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (BATCH, 3, IMAGE, IMAGE), generator=gen, dtype=torch.uint8)
    masks = (torch.rand(BATCH, 1, IMAGE, IMAGE, generator=gen) > 0.5).to(torch.uint8)
    return images, masks


def step(path, images, masks, device):
    """One train step of ``gated`` from seed-0 weights on ``path``: (loss,
    the flattened gradient of every parameter as the step left it)."""
    dtype = torch.float32 if path == "f32" else torch.bfloat16
    use_kernels = None if path in ("kernel", "k7_plain") else False
    model = create_model("gated", seed=0, dtype=dtype, image_size=IMAGE, device=device,
                         use_kernels=use_kernels)
    run = make_train_step(model)
    kernel = k7.fused_axial_train
    if path == "k7_plain":
        k7.fused_axial_train = k7.fused_axial_train_reference
    try:
        loss = run(create_train_state(model), images, masks)["loss"].item()
    finally:
        k7.fused_axial_train = kernel
    grad = torch.cat([p.grad.float().flatten() for p in model.module.parameters()])
    return loss, grad


def readings(batches, device, paths=PATHS):
    """Per batch: each path's loss; the kernel path's relative loss
    difference (``rel_<path>``) and gradient cosine (``cos_<path>``) against
    each other path; k7_plain's relative loss difference against module
    (``rel_plain_module``). Batch seeds 0 .. batches - 1; ``paths`` starts
    with "kernel"."""
    out = []
    for s in range(batches):
        images, masks = batch_of(s)
        res = {p: step(p, images, masks, device) for p in paths}
        loss_k, grad_k = res["kernel"]
        row = {f"loss_{p}": res[p][0] for p in paths}
        for p in paths[1:]:
            row[f"rel_{p}"] = abs(loss_k - res[p][0]) / abs(res[p][0])
            row[f"cos_{p}"] = torch.nn.functional.cosine_similarity(grad_k, res[p][1],
                                                                    dim=0).item()
        if "k7_plain" in res and "module" in res:     # two bf16 paths without the kernel
            row["rel_plain_module"] = abs(res["k7_plain"][0] - res["module"][0]) / abs(
                res["module"][0])
        out.append(row)
    return out


def medians(rows):
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe steps the kernel path on the card")
    device = torch.device("cuda")
    print(f"gated train step on {torch.cuda.get_device_name(0)}, package "
          f"{unet_zoo_tpu_torch.__file__}, {args.batches} batches of "
          f"[{BATCH}, 3, {IMAGE}, {IMAGE}]", flush=True)
    rows = readings(args.batches, device)
    for s, r in enumerate(rows):
        print(f"batch {s}: " + ", ".join(f"{k} {v:.5f}" for k, v in r.items()), flush=True)
    print("median: " + ", ".join(f"{k} {v:.5f}" for k, v in medians(rows).items()), flush=True)


if __name__ == "__main__":
    main()
