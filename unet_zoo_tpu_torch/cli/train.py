"""Train every model a YAML config names, one after another.

    python -m unet_zoo_tpu_torch.cli.train --config <yaml> [--resume] [--device cuda|cpu]

Counterpart of ``scripts/train.py``: the same YAML schema, the same run
directory (``<working_dir>/overall_runs_<timestamp>/<model>/{checkpoints,
logs,results}``) and per-model parameters merged onto copies of the global
defaults. ``tpu.compute_dtype: bfloat16`` trains in bfloat16 on float32
parameters. The device defaults to CUDA and the run raises without it;
``--device cpu`` runs on the CPU. ``--resume`` continues each model from
its last checkpoint (pin ``run_timestamp`` in the YAML). Needs PyYAML, and
PIL for the on-disk dataset. The comparison plots are not ported yet.

With ``gpu.use_multi_gpu: true`` it trains on every process of a launcher's
run, one card each::

    torchrun --nproc-per-node N -m unet_zoo_tpu_torch.cli.train --config <yaml>

Each rank joins the process group (``parallel.initialize_distributed``:
NCCL on CUDA, gloo with ``--device cpu``) and trains its rows of every
global batch over the mesh ``parallel.create_mesh_for_batch`` builds, by
``gpu.multi_gpu_strategy`` (DataParallel or fsdp); only rank 0 writes logs,
events and checkpoints. Without a launcher the run is one process on one
device and builds no mesh, whatever ``use_multi_gpu`` says.
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch

from unet_zoo_tpu_torch.config import Config
from unet_zoo_tpu_torch.data.datasets import BoneDataset
from unet_zoo_tpu_torch.data.loader import create_loader
from unet_zoo_tpu_torch.models import create_model
from unet_zoo_tpu_torch.parallel import create_mesh_for_batch, initialize_distributed, is_primary
from unet_zoo_tpu_torch.train.loop import train_model
from unet_zoo_tpu_torch.train.metrics import check_dataset_integrity
from unet_zoo_tpu_torch.utils.logger import Logger


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Train UNet Zoo models (PyTorch port).")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the YAML configuration file.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from each model's last checkpoint "
                             "(requires run_timestamp pinned in the YAML).")
    parser.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                        help="Device to train on (default: cuda; raises without it).")
    return parser.parse_args(argv)


def setup_paths(working_dir, model_name, timestamp, base_run_dir, create_dirs=True):
    """Per-model run directories (made where ``create_dirs``) and checkpoint paths."""
    model_run_dir = os.path.join(base_run_dir, model_name)
    checkpoint_dir = os.path.join(model_run_dir, "checkpoints")
    log_dir = os.path.join(model_run_dir, "logs")
    results_dir = os.path.join(model_run_dir, "results")
    for d in (checkpoint_dir, log_dir, results_dir) if create_dirs else ():
        os.makedirs(d, exist_ok=True)
    return {
        "run_dir": model_run_dir,
        "checkpoint_dir": checkpoint_dir,
        "log_dir": log_dir,
        "results_dir": results_dir,
        "training_log_path": os.path.join(log_dir, "training_log.txt"),
        "test_results_path": os.path.join(results_dir, "test_results.csv"),
        "model_checkpoint_paths": {
            "best": os.path.join(checkpoint_dir, f"{model_name}_best"),
            "last": os.path.join(checkpoint_dir, f"{model_name}_last"),
        },
    }


def merged_model_params(overall_config, model_name, num_classes, image_size,
                        compute_dtype="float32"):
    """Per-model YAML params over the global defaults, on a copy."""
    params = dict(
        overall_config.get("models", {}).get("params", {}).get(model_name) or {})
    params.setdefault("in_channels", 3)
    params.setdefault("num_classes", num_classes)
    params.setdefault("image_size", image_size)
    if compute_dtype == "bfloat16" and "dtype" not in params:
        params["dtype"] = torch.bfloat16
    return params


def main(argv=None):
    import yaml

    args = parse_arguments(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    with open(args.config, "r") as f:
        overall_config = yaml.safe_load(f)
    overall_config.setdefault(
        "run_timestamp", datetime.datetime.now().strftime("%Y%m%d-%H%M%S"))

    launched = initialize_distributed(device=args.device)
    primary = is_primary()
    config = Config(overall_config, create_dirs=primary, device=args.device)
    device = config.DEVICE
    # a single process (no launcher) trains on its one device, as before
    n_devices = config.device_count()
    mesh = (create_mesh_for_batch(config.BATCH_SIZE, n_devices,
                                  model_axis=config.MODEL_PARALLEL_SIZE,
                                  device_type=device.type)
            if config.USE_MULTI_GPU and launched else None)
    logger = Logger(os.path.join(config.OVERALL_LOG_DIR, "overall_training_log.txt")
                    if primary else None)

    logger.log_both("=" * 80)
    logger.log_both(f"UNET ZOO (PyTorch) TRAINING RUN — {config.RUN_TIMESTAMP}")
    logger.log_both(f"  Device Configuration: {config.get_device_info()}")
    logger.log_both(f"  Multi-device enabled: {config.USE_MULTI_GPU}")
    logger.log_both(f"  Early Stopping Patience: {config.EARLY_STOPPING_PATIENCE} epochs")
    logger.log_both(f"  LR Scheduler Patience: {config.LR_SCHEDULER_PATIENCE} epochs")
    logger.log_both(f"  Input Image Size: {config.IMAGE_SIZE}x{config.IMAGE_SIZE}")
    logger.log_both(f"  Number of Classes: {config.NUM_CLASSES}")

    check_dataset_integrity(config.DATASET_DIR, logger)

    train_dataset = BoneDataset(config.DATASET_DIR, split="train",
                                image_size=config.IMAGE_SIZE,
                                augment=config.AUGMENT and not config.AUGMENT_ON_DEVICE,
                                cache=config.CACHE_DATA,
                                transfer_dtype=config.TRANSFER_DTYPE,
                                decoder=config.DECODER)
    val_dataset = BoneDataset(config.DATASET_DIR, split="valid",
                              image_size=config.IMAGE_SIZE,
                              cache=config.CACHE_DATA,
                              transfer_dtype=config.TRANSFER_DTYPE,
                              decoder=config.DECODER)
    logger.log_both(f"Train dataset size: {len(train_dataset)}")
    logger.log_both(f"Validation dataset size: {len(val_dataset)}")

    pin = device.type == "cuda"
    train_loader = create_loader(train_dataset, batch_size=config.BATCH_SIZE,
                                 shuffle=True, drop_last=True,
                                 num_workers=config.NUM_WORKERS,
                                 backend=config.LOADER, seed=config.SEED, pin_memory=pin)
    val_loader = create_loader(val_dataset, batch_size=config.BATCH_SIZE,
                               shuffle=False, num_workers=config.NUM_WORKERS,
                               backend=config.LOADER, pin_memory=pin)

    logger.log_both("\n" + "=" * 80)
    logger.log_both("STARTING MULTI-MODEL COMPARISON TRAINING")
    logger.log_both("=" * 80)

    trained = 0
    for model_name in overall_config["models"]["names"]:
        logger.log_both(f"\nTraining {model_name.upper()}...")
        paths = setup_paths(config.WORKING_DIR, model_name,
                            config.RUN_TIMESTAMP, config.BASE_RUN_DIR, create_dirs=primary)
        params = merged_model_params(
            overall_config, model_name, config.NUM_CLASSES, config.IMAGE_SIZE,
            config.COMPUTE_DTYPE)
        model = create_model(model_name, device=device, seed=config.SEED, **params)
        n_params = sum(p.numel() for p in model.module.parameters())
        logger.log_both(f"{model_name.upper()} parameters: {n_params:,}")

        model_logger = Logger(paths["training_log_path"] if primary else None)
        try:
            train_model(
                model, train_loader, val_loader, config, model_name,
                paths["model_checkpoint_paths"]["best"],
                paths["model_checkpoint_paths"]["last"],
                model_logger, mesh=mesh, resume=args.resume)
            trained += 1
        finally:
            model_logger.close()

    if trained:
        logger.log_both("Comparison plots: not ported yet (ROADMAP Queue 1 item 11)")
    train_loader.close()
    val_loader.close()
    logger.close()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
