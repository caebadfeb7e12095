"""The epoch loop: train and validate, Dice-plateau learning rate, early
stopping, best and last checkpoints, resume, logging.

Counterpart of ``unet_zoo_tpu/train/loop.py``, with the same log lines and
cadences (the file log every 50 batches, TensorBoard every 100, one block
an epoch):

* each step updates the module and optimizer in place (``train/steps.py``);
  loss and Dice stay device scalars, and the host reads them only where
  the JAX loop casts them to ``float`` (the logs, the epoch means);
* validation runs the live module in eval mode (no weights are copied in);
  a bfloat16 CUDA ``unet`` folds K1's weights on each call, so each epoch
  validates the weights it trained;
* the best checkpoint is written on each improvement and the last every
  epoch, with the optimizer, step, scheduler and early-stopping state,
  which ``resume=True`` restores;
* TensorBoard scalars go through ``utils/tb_writer.py`` (no ``tensorboard``
  install needed) and there is no progress bar.

Given a ``mesh`` (``parallel.create_mesh_for_batch``; one process a card),
``gpu.multi_gpu_strategy`` places the state: ``DataParallel`` replicates it
from rank 0, ``fsdp`` shards the parameters and AdamW moments
(``parallel/fsdp.py``). Each rank trains on its rows of every global batch
with the data-parallel steps, whose losses, Dice and batch statistics are
the global batch's, so every rank's scheduler and early stopping decide
alike. Only the primary process writes logs, TensorBoard events and
checkpoints. ``tensor_parallel`` and ``expert`` (ROADMAP Queue 1 item 10c)
and ``pipeline`` and ``spatial`` (item 10b) raise. Without a mesh the
strategy is not read, as in JAX: the model trains on its own device.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import torch

from unet_zoo_tpu_torch.config import Config
from unet_zoo_tpu_torch.data.loader import prefetch_to_device
from unet_zoo_tpu_torch.models import ZooModel
from unet_zoo_tpu_torch.parallel.multihost import is_primary
from unet_zoo_tpu_torch.train.early_stopping import EarlyStopping
from unet_zoo_tpu_torch.train.losses import bce_with_logits, get_criterion
from unet_zoo_tpu_torch.train.lr_scheduler import DiceScheduler
from unet_zoo_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    get_lr,
    make_eval_step,
    make_train_step,
    set_lr,
    variables_of,
)
from unet_zoo_tpu_torch.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)
from unet_zoo_tpu_torch.utils.logger import Logger
from unet_zoo_tpu_torch.utils.tb_writer import EventFileWriter

_DATA_PARALLEL = ("dataparallel", "data_parallel", "dp", "ddp")
_FSDP = ("fsdp", "zero3")
# the strategies still to port, by their JAX names, and the ROADMAP item of each
_NOT_PORTED = {("tensor_parallel", "tp", "megatron"): "10c",
               ("expert", "expert_parallel", "ep", "moe"): "10c",
               ("pipeline", "pp", "gpipe"): "10b",
               ("spatial", "spatial_parallel", "sp"): "10b"}


class _Silent:
    """The logger and event writer of a process other than the primary."""

    def log_both(self, message: str) -> None:
        pass

    log_file_only = log_both

    def add_scalar(self, *args) -> None:
        pass

    def close(self) -> None:
        pass


def _place_state(state: TrainState, mesh, strategy: str) -> TrainState:
    """``state`` laid over ``mesh`` by ``gpu.multi_gpu_strategy`` (JAX's
    names): replicated for DataParallel, sharded for fsdp; the strategies
    not ported yet raise, naming their ROADMAP item."""
    from unet_zoo_tpu_torch.parallel import replicate_state, shard_state_fsdp

    strategy = strategy.lower()
    for names, item in _NOT_PORTED.items():
        if strategy in names:
            raise NotImplementedError(f"multi_gpu_strategy {strategy!r} is not ported yet "
                                      f"(ROADMAP Queue 1 item {item})")
    if strategy in _FSDP:
        return shard_state_fsdp(mesh, state)
    if strategy in _DATA_PARALLEL:
        return replicate_state(mesh, state)
    raise ValueError(f"Unknown multi_gpu_strategy {strategy!r}: expected DataParallel, fsdp, "
                     "tensor_parallel, expert, pipeline, or spatial")


def _device_of(model: ZooModel) -> torch.device:
    return next(model.module.parameters()).device


def _epoch_mean(acc: List[torch.Tensor]) -> float:
    if not acc:
        return 0.0
    return float(torch.stack(acc).mean())


def train_one_epoch(train_step, state: TrainState, dataloader, epoch: int,
                    model_name: str, writer, logger: Logger,
                    device=None, mesh=None, microbatches: int = 1
                    ) -> Tuple[TrainState, float, float, float]:
    """One pass over ``dataloader``; returns the state, the epoch's mean
    loss and Dice, and images a second (loader and step; the global batch's
    images under a ``mesh``)."""
    losses, dices = [], []
    steps_per_epoch = len(dataloader)
    n_images = 0
    world = 1 if mesh is None else mesh.size(0)
    t0 = time.perf_counter()
    for idx, (imgs, masks, _) in enumerate(prefetch_to_device(
            dataloader, size=2, device=device, mesh=mesh, microbatches=microbatches)):
        metrics = train_step(state, imgs, masks)
        losses.append(metrics["loss"])
        dices.append(metrics["dice"])
        n_images += int(imgs.shape[0]) * world

        if idx % 50 == 0:  # file-log cadence; the loop's only per-batch host sync
            logger.log_file_only(
                f"{model_name} - Batch {idx}: Loss={float(metrics['loss']):.4f}, "
                f"Dice={float(metrics['dice']):.4f}"
            )
        if idx % 100 == 0:  # TensorBoard cadence
            global_step = epoch * steps_per_epoch + idx
            writer.add_scalar(f"Batch/{model_name}_Train_Loss",
                              float(metrics["loss"]), global_step)
            writer.add_scalar(f"Batch/{model_name}_Train_Dice",
                              float(metrics["dice"]), global_step)
    mean_loss, mean_dice = _epoch_mean(losses), _epoch_mean(dices)
    # _epoch_mean waits for the device, so the clock covers the epoch's compute
    ips = n_images / max(time.perf_counter() - t0, 1e-9)
    return state, mean_loss, mean_dice, ips


def validate_one_epoch(eval_step, variables, dataloader, model_name: str,
                       logger: Logger, device=None, mesh=None) -> Tuple[float, float]:
    """Mean loss and Dice of ``eval_step`` over ``dataloader``; ``variables``
    None evaluates the module's own weights. Under a ``mesh`` each rank
    evaluates its rows of each batch and every rank gets the global means."""
    losses, dices = [], []
    for imgs, masks, _ in prefetch_to_device(dataloader, size=2, device=device, mesh=mesh):
        metrics = eval_step(variables, imgs, masks)
        losses.append(metrics["loss"])
        dices.append(metrics["dice"])
    return _epoch_mean(losses), _epoch_mean(dices)


def restore_checkpoint(path: str, state: TrainState, dice_scheduler: DiceScheduler,
                       early_stopping: EarlyStopping) -> int:
    """Load the last checkpoint at ``path`` into the module, the optimizer,
    the step count, the scheduler and early stopping, and set the
    scheduler's learning rate; returns the epoch it was saved after."""
    restored = load_checkpoint(path)
    state.module.load_state_dict(restored["variables"], strict=True)
    state.optimizer.adamw.load_state_dict(restored["opt_state"])
    state.step = int(restored["step"])
    if "scheduler" in restored:
        dice_scheduler.load_state_dict(restored["scheduler"])
    if "early_stopping" in restored:
        # the best weights are in the best checkpoint, not the last
        early_stopping.load_state_dict(restored["early_stopping"])
    set_lr(state, dice_scheduler.lr)
    return int(restored.get("meta", {}).get("epoch", 0))


def train_model(
    model: ZooModel,
    train_dataloader,
    val_dataloader,
    config: Config,
    model_name: str,
    best_checkpoint_path: str,
    last_checkpoint_path: str,
    logger: Logger,
    mesh=None,
    state: Optional[TrainState] = None,
    resume: bool = False,
) -> Tuple[List[float], List[float], List[float], List[float], bool]:
    """Train ``model`` for ``config.EPOCHS`` epochs (fewer if early stopping
    triggers); returns the per-epoch train and val losses and Dice and
    whether it stopped early.

    ``state`` None trains the module's current weights with a new optimizer.
    ``resume=True`` restores the weights, optimizer state, step, scheduler
    and early-stopping state from ``last_checkpoint_path`` where it exists
    and continues after the saved epoch. ``mesh``: see the module docstring
    (``state`` is then an unsharded one, placed here after the restore).
    """
    strategy = str(getattr(config, "MULTI_GPU_STRATEGY", "DataParallel")).lower()
    primary = is_primary()
    if not primary:
        logger = _Silent()
    device = _device_of(model)
    tb_dir = os.path.join(config.TENSORBOARD_BASE_DIR,
                          model_name.replace(" ", "_").lower())
    writer = EventFileWriter(tb_dir) if primary else _Silent()
    logger.log_both(f"TensorBoard logs for {model_name} will be saved to: {tb_dir}")

    early_stopping = EarlyStopping(
        patience=config.EARLY_STOPPING_PATIENCE, min_delta=0.0,
        restore_best_weights=True, verbose=primary, mode="max")
    dice_scheduler = DiceScheduler(
        lr=config.LEARNING_RATE, patience=config.LR_SCHEDULER_PATIENCE,
        factor=config.LR_SCHEDULER_FACTOR, min_lr=config.MIN_LR,
        min_delta=0.0, verbose=primary, mode="max")

    start_epoch = 0
    if state is None:
        state = create_train_state(
            model, learning_rate=config.LEARNING_RATE,
            weight_decay=config.WEIGHT_DECAY, max_grad_norm=config.MAX_GRAD_NORM)

    if resume and checkpoint_exists(last_checkpoint_path):
        start_epoch = restore_checkpoint(last_checkpoint_path, state, dice_scheduler,
                                         early_stopping)
        logger.log_both(
            f"Resumed {model_name} from {last_checkpoint_path} at epoch "
            f"{start_epoch} (step {int(state.step)}, lr {dice_scheduler.lr:.2e})")

    if mesh is not None:
        state = _place_state(state, mesh, strategy)
        logger.log_both(f"  Parallelism: {strategy} over mesh "
                        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    # flips run in the train step only when both switches are on (the CLI
    # then turns the host-side flips off)
    criterion = get_criterion(getattr(config, "LOSS", "bce"),
                              **getattr(config, "LOSS_KWARGS", {}))
    if getattr(config, "LOSS", "bce") != "bce":
        logger.log_both(
            f"  Loss: {config.LOSS} {getattr(config, 'LOSS_KWARGS', {}) or ''}")
    accum = getattr(config, "GRAD_ACCUM_STEPS", 1)
    train_step = make_train_step(
        model, criterion=criterion,
        augment=(getattr(config, "AUGMENT", False)
                 and getattr(config, "AUGMENT_ON_DEVICE", False)),
        accum_steps=accum, mesh=mesh)
    eval_step = make_eval_step(model, criterion=criterion, mesh=mesh)

    train_losses: List[float] = []
    train_dcs: List[float] = []
    val_losses: List[float] = []
    val_dcs: List[float] = []
    early_stopped = False

    logger.log_both(
        f"\nStarting training for {model_name} - {config.EPOCHS} epochs on "
        f"{config.get_device_info()}")
    logger.log_both(
        f"  Early Stopping: patience={config.EARLY_STOPPING_PATIENCE}, mode='max'")
    logger.log_both(
        f"  LR Scheduler: patience={config.LR_SCHEDULER_PATIENCE}, "
        f"factor={config.LR_SCHEDULER_FACTOR}, min_lr={config.MIN_LR}, mode='max'")

    epoch = start_epoch - 1
    for epoch in range(start_epoch, config.EPOCHS):
        state, train_loss, train_dc, train_ips = train_one_epoch(
            train_step, state, train_dataloader, epoch, model_name, writer,
            logger, device, mesh, accum)
        train_losses.append(train_loss)
        train_dcs.append(train_dc)

        val_loss, val_dc = validate_one_epoch(
            eval_step, None, val_dataloader, model_name, logger, device, mesh)
        val_losses.append(val_loss)
        val_dcs.append(val_dc)

        new_lr = dice_scheduler.step(val_dc, epoch + 1)
        if abs(new_lr - get_lr(state)) > 1e-12:
            set_lr(state, new_lr)

        improved = early_stopping.best_score is None or (
            val_dc > early_stopping.best_score)
        early_stopping(val_dc, variables_of(state), epoch + 1)
        if improved:
            save_checkpoint(best_checkpoint_path, {
                "variables": variables_of(state),
                "meta": {"epoch": epoch + 1, "val_dice": val_dc,
                         "model_name": model_name},
            })
        save_checkpoint(last_checkpoint_path, {
            "variables": variables_of(state),
            "opt_state": state.optimizer.adamw.state_dict(),
            "step": int(state.step),
            "meta": {"epoch": epoch + 1, "val_dice": val_dc,
                     "model_name": model_name},
            "scheduler": dice_scheduler.state_dict(),
            "early_stopping": early_stopping.state_dict(),
        })

        current_lr = get_lr(state)
        writer.add_scalar(f"Epoch/{model_name}_Train_Loss", train_loss, epoch + 1)
        writer.add_scalar(f"Epoch/{model_name}_Train_Dice", train_dc, epoch + 1)
        writer.add_scalar(f"Epoch/{model_name}_Val_Loss", val_loss, epoch + 1)
        writer.add_scalar(f"Epoch/{model_name}_Val_Dice", val_dc, epoch + 1)
        writer.add_scalar(f"{model_name}_Learning_Rate", current_lr, epoch + 1)

        epoch_log = "-" * 60
        epoch_log += f"\n{model_name} - Epoch {epoch + 1}/{config.EPOCHS}"
        epoch_log += f"\n  Train Loss: {train_loss:.6f} | Train DICE: {train_dc:.6f}"
        epoch_log += f"\n  Val Loss:   {val_loss:.6f} | Val DICE:   {val_dc:.6f}"
        epoch_log += f"\n  Learning Rate: {current_lr:.8f}"
        epoch_log += f"\n  Train throughput: {train_ips:.1f} img/s (loader + step)"
        epoch_log += f"\n  Best Val Dice: {early_stopping.get_best_score():.6f}"
        epoch_log += f"\n{'-' * 60}"
        logger.log_both(epoch_log)

        if early_stopping.early_stop:
            logger.log_both(
                f"\nEarly stopping triggered for {model_name} at epoch {epoch + 1}")
            logger.log_both(
                f"Best validation dice: {early_stopping.get_best_score():.6f}")
            early_stopped = True
            break

    writer.close()
    final = f"Training {'stopped early' if early_stopped else 'completed'} for {model_name}"
    final += f" after {epoch + 1 if early_stopped else config.EPOCHS} epochs"
    logger.log_both(final)
    logger.log_both(
        f"Best validation Dice coefficient for {model_name}: "
        f"{early_stopping.get_best_score():.6f}")
    return train_losses, train_dcs, val_losses, val_dcs, early_stopped


def evaluate_model(model: ZooModel, variables, test_dataloader, model_name: str,
                   logger: Logger, criterion=bce_with_logits) -> Tuple[float, float]:
    """Test-set loss and Dice of ``variables`` (a ``state_dict``, loaded into
    the module once; None: the module's own weights)."""
    if variables is not None:
        model.module.load_state_dict(variables, strict=True)
    eval_step = make_eval_step(model, criterion=criterion)
    logger.log_both(f"\nEvaluating {model_name} on test set...")
    loss, dice = validate_one_epoch(eval_step, None, test_dataloader, model_name, logger,
                                    _device_of(model))
    logger.log_both(f"{model_name} - Final Test Loss: {loss:.4f}")
    logger.log_both(f"{model_name} - Final Test DICE: {dice:.4f}")
    return loss, dice
