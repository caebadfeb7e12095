"""Building blocks of the port's models."""

from unet_zoo_tpu_torch.nn.blocks import (
    ConvNormAct,
    DoubleConv,
    DownSample,
    Int8Conv,
    OutConv,
    TransposedUp,
    UpSampleUNet,
    attach_int8,
    batch_norm,
    conv,
    conv_norm_act,
    init_weights,
    recording_conv_inputs,
    update_running_stats,
)

__all__ = ["ConvNormAct", "DoubleConv", "DownSample", "Int8Conv", "OutConv", "TransposedUp",
           "UpSampleUNet", "attach_int8", "batch_norm", "conv", "conv_norm_act", "init_weights",
           "recording_conv_inputs", "update_running_stats"]
