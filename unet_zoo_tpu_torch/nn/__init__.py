"""Building blocks of the port's models."""

from unet_zoo_tpu_torch.nn.blocks import (
    ConvBlock,
    ConvNormAct,
    DoubleConv,
    DoubleConvMid,
    DownSample,
    Int8Conv,
    OutConv,
    ResidualConv,
    TransposedUp,
    UpConvBlock,
    UpSampleUNet,
    attach_int8,
    batch_norm,
    conv,
    conv_norm_act,
    gated_conv,
    init_weights,
    recording_conv_inputs,
    update_running_stats,
)

__all__ = ["ConvBlock", "ConvNormAct", "DoubleConv", "DoubleConvMid", "DownSample", "Int8Conv",
           "OutConv", "ResidualConv", "TransposedUp", "UpConvBlock", "UpSampleUNet", "attach_int8",
           "batch_norm", "conv", "conv_norm_act", "gated_conv", "init_weights",
           "recording_conv_inputs", "update_running_stats"]
