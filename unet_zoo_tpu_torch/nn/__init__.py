"""Building blocks of the port's models."""

from unet_zoo_tpu_torch.nn.blocks import (
    DoubleConv,
    DownSample,
    OutConv,
    TransposedUp,
    UpSampleUNet,
    batch_norm,
    conv,
    conv_norm_act,
    init_weights,
    update_running_stats,
)

__all__ = ["DoubleConv", "DownSample", "OutConv", "TransposedUp", "UpSampleUNet",
           "batch_norm", "conv", "conv_norm_act", "init_weights", "update_running_stats"]
