"""Run configuration from the YAML schema. Counterpart of ``unet_zoo_tpu/config.py``.

The same schema (``general/data/training/gpu/tpu/models``) and the same flat
UPPERCASE attributes. ``tpu.compute_dtype`` ('float32' | 'bfloat16') is the
models' compute type (``create_model``'s ``dtype``). The device is the
port's own argument (``device``, default ``"cuda"``). ``gpu.use_multi_gpu``
trains on every process of a launcher's run, one card each
(``torchrun --nproc-per-node N``); one process cannot drive several cards.
"""

from __future__ import annotations

import datetime
import os
import platform
from typing import Any, Dict, Optional

import torch


class Config:
    def __init__(self, overall_config_dict: Dict[str, Any], create_dirs: bool = True,
                 device: str = "cuda"):
        d = overall_config_dict
        self.PROJECT_NAME = d["general"]["project_name"]
        self.WORKING_DIR = d["general"]["working_dir"]

        self.DATASET_DIR = d["data"]["dataset_dir"]
        self.NUM_WORKERS = d["data"]["num_workers"]
        self.IMAGE_SIZE = d["data"].get("image_size", 512)
        self.AUGMENT = d["data"].get("augment", False)
        # flips on the device inside the train step (data/augment.py); when
        # true, the CLI turns host-side flips off
        self.AUGMENT_ON_DEVICE = d["data"].get("augment_on_device", False)
        self.CACHE_DATA = d["data"].get("cache", False)
        # host input pipeline: 'native' (data/loader.py); 'grain' raises
        self.LOADER = d["data"].get("loader", "native")
        # decode engine: 'auto' and 'pil' decode with PIL; 'cpp' raises
        self.DECODER = d["data"].get("decoder", "auto")
        # host->device transfer type: 'uint8' ships raw pixels and
        # normalises on the device; 'float32' normalises on the host
        self.TRANSFER_DTYPE = d["data"].get("transfer_dtype", "uint8")

        t = d["training"]
        self.EPOCHS = t["epochs"]
        self.BATCH_SIZE = t["batch_size"]
        self.LEARNING_RATE = t["learning_rate"]
        self.EARLY_STOPPING_PATIENCE = t["early_stopping_patience"]
        self.LR_SCHEDULER_PATIENCE = t["lr_scheduler_patience"]
        self.LR_SCHEDULER_FACTOR = t["lr_scheduler_factor"]
        # k > 1 runs k microbatches and one optimizer update
        self.GRAD_ACCUM_STEPS = t.get("grad_accum_steps", 1)
        self.MIN_LR = float(t["min_lr"])
        self.NUM_CLASSES = t["num_classes"]
        self.WEIGHT_DECAY = float(t.get("weight_decay", 1e-5))
        self.MAX_GRAD_NORM = float(t.get("max_grad_norm", 1.0))
        # per-output criterion (train/losses.py get_criterion)
        self.LOSS: str = t.get("loss", "bce")
        self.LOSS_KWARGS: Dict[str, Any] = dict(t.get("loss_kwargs") or {})
        # weight-init and shuffle seed
        self.SEED: int = int(t.get("seed", 0))

        gpu = d.get("gpu", {})
        self.USE_MULTI_GPU = gpu.get("use_multi_gpu", False)
        self.GPU_IDS = gpu.get("gpu_ids", [])
        self.SINGLE_GPU_ID = gpu.get("single_gpu_id", 0)
        self.MULTI_GPU_STRATEGY = gpu.get("multi_gpu_strategy", "DataParallel")

        tpu = d.get("tpu", {})
        self.NUM_DEVICES: Optional[int] = tpu.get("num_devices")
        self.COMPUTE_DTYPE: str = tpu.get("compute_dtype", "float32")
        self.MODEL_PARALLEL_SIZE: int = int(tpu.get("model_parallel_size", 1))
        self.PIPELINE_MICROBATCHES: int = int(tpu.get("pipeline_microbatches", 4))

        self.DEVICE = torch.device(device)

        self.RUN_TIMESTAMP = d.get(
            "run_timestamp",
            datetime.datetime.now().strftime("%Y%m%d-%H%M%S_fallback"),
        )
        self.BASE_RUN_DIR = os.path.join(
            self.WORKING_DIR, f"overall_runs_{self.RUN_TIMESTAMP}")
        self.OVERALL_LOG_DIR = os.path.join(self.BASE_RUN_DIR, "overall_logs")
        self.TENSORBOARD_BASE_DIR = os.path.join(
            self.BASE_RUN_DIR, "tensorboard_logs")
        if create_dirs:
            os.makedirs(self.OVERALL_LOG_DIR, exist_ok=True)
            os.makedirs(self.TENSORBOARD_BASE_DIR, exist_ok=True)

    def device_count(self) -> int:
        """The devices a run uses: 1, or with ``use_multi_gpu`` the world
        size of the launcher's run (one process a card), bounded by
        ``num_devices`` or ``gpu_ids`` (``create_mesh_for_batch`` refuses a
        bound below the world). Without a launcher, more than one device left
        raises: each card needs its own process."""
        if not self.USE_MULTI_GPU:
            return 1
        from unet_zoo_tpu_torch.parallel.multihost import process_count

        world = process_count()
        n = world if world > 1 else (
            torch.cuda.device_count() if self.DEVICE.type == "cuda" else 1)
        if self.NUM_DEVICES:
            n = min(self.NUM_DEVICES, n)
        elif self.GPU_IDS:
            n = min(len(self.GPU_IDS), n)
        if n > 1 and world == 1:
            raise NotImplementedError(
                f"use_multi_gpu over {n} devices from one process: the port runs one process "
                f"a card (ROADMAP Queue 1 item 10a); launch with torchrun --nproc-per-node {n}, "
                "or bound it to one device with tpu.num_devices: 1")
        return n

    def get_device_info(self) -> str:
        """For example ``GPU (NVIDIA H100 80GB HBM3) x1``."""
        if self.DEVICE.type == "cuda":
            kind = f"GPU ({torch.cuda.get_device_name(self.DEVICE)})"
        else:
            kind = f"CPU ({platform.machine()})"
        return f"{kind} x{self.device_count()}"
