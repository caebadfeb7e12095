"""Evaluate checkpoints on a dataset's test split.

    python -m unet_zoo_tpu_torch.cli.evaluate --config <yaml> [--device cuda|cpu]

Counterpart of ``scripts/evaluate.py``, reading the port's checkpoints
(``utils/checkpoint.py``) and writing
``<working_dir>/evaluation_<timestamp>/{evaluation_log.txt,
test_results_summary.txt}``. YAML schema::

    general: {project_name, working_dir}
    data: {dataset_dir, num_workers, image_size}
    evaluation: {batch_size, num_classes, visualization_samples}
    models:
      models_to_evaluate:
        - name: unet
          checkpoint: /path/to/unet_best
          params: {...}

A model whose evaluation fails is logged and skipped, as in the JAX script,
and the run then exits with status 1. The device defaults to CUDA and the
run raises without it. The visualisations are not ported yet.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

import torch

from unet_zoo_tpu_torch.data.datasets import BoneDataset
from unet_zoo_tpu_torch.data.loader import create_loader
from unet_zoo_tpu_torch.models import create_model
from unet_zoo_tpu_torch.train.loop import evaluate_model
from unet_zoo_tpu_torch.train.losses import get_criterion
from unet_zoo_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint
from unet_zoo_tpu_torch.utils.logger import Logger
from unet_zoo_tpu_torch.utils.visualize import save_all_test_results


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate UNet Zoo checkpoints (PyTorch port).")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="Device to evaluate on (default: cuda; raises without it).")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    import yaml

    args = parse_arguments(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    with open(args.config, "r") as f:
        cfg = yaml.safe_load(f)
    ts = cfg.get("run_timestamp",
                 datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))
    working_dir = cfg["general"]["working_dir"]
    eval_dir = os.path.join(working_dir, f"evaluation_{ts}")
    os.makedirs(eval_dir, exist_ok=True)
    logger = Logger(os.path.join(eval_dir, "evaluation_log.txt"))

    data = cfg["data"]
    image_size = data.get("image_size", 512)
    ev = cfg.get("evaluation", {})
    batch_size = ev.get("batch_size", 4)
    num_classes = ev.get("num_classes", 1)
    num_samples = ev.get("visualization_samples", 5)
    criterion = get_criterion(ev.get("loss", "bce"),
                              **(ev.get("loss_kwargs") or {}))

    test_ds = BoneDataset(data["dataset_dir"], "test", image_size=image_size,
                          transfer_dtype=data.get("transfer_dtype", "uint8"),
                          decoder=data.get("decoder", "auto"))
    test_loader = create_loader(test_ds, batch_size,
                                num_workers=data.get("num_workers", 4),
                                backend=data.get("loader", "native"),
                                pin_memory=args.device == "cuda")
    logger.log_both(f"Test dataset size: {len(test_ds)}")

    results = {}
    failed = []
    for entry in cfg["models"]["models_to_evaluate"]:
        name = entry["name"]
        ckpt = entry["checkpoint"]
        params = dict(entry.get("params") or {})
        params.setdefault("in_channels", 3)
        params.setdefault("num_classes", num_classes)
        params.setdefault("image_size", image_size)
        if not checkpoint_exists(ckpt):
            logger.log_both(f"Checkpoint not found for {name}: {ckpt}. Skipping.")
            continue
        try:
            model = create_model(name, device=args.device, **params)
            restored = load_checkpoint(ckpt)
            variables = restored.get("variables", restored)
            results[name] = evaluate_model(model, variables, test_loader, name,
                                           logger, criterion=criterion)
        except Exception as e:
            logger.log_both(f"Error evaluating {name}: {e}")
            failed.append(name)

    if results:
        save_all_test_results(
            results, os.path.join(eval_dir, "test_results_summary.txt"), logger)
    if results and num_samples > 0:
        logger.log_both("Visualisation samples: not ported yet (ROADMAP Queue 1 item 11)")
    test_loader.close()
    logger.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
