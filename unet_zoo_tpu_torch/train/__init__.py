"""Training of the port: losses, metrics and the train and eval steps."""

from unet_zoo_tpu_torch.train.losses import CRITERIA, get_criterion, multi_output_loss
from unet_zoo_tpu_torch.train.metrics import boundary_f1, dice_coefficient, iou_score
from unet_zoo_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    get_lr,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_lr,
    variables_of,
)

__all__ = ["CRITERIA", "TrainState", "boundary_f1", "create_train_state", "dice_coefficient",
           "get_criterion", "get_lr", "iou_score", "make_eval_step", "make_optimizer",
           "make_train_step", "multi_output_loss", "set_lr", "variables_of"]
