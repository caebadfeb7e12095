"""Building blocks of the port's models."""

from unet_zoo_tpu_torch.nn.blocks import (
    ConvBlock,
    ConvNormAct,
    DoubleConv,
    DoubleConvMid,
    Down,
    DownSample,
    Int8Conv,
    OutConv,
    ResidualConv,
    TransposedUp,
    UpBilinear,
    UpConvBlock,
    UpSampleUNet,
    ZooDoubleConv,
    attach_int8,
    batch_norm,
    conv,
    conv_norm_act,
    double_conv_norm_act,
    conv_transpose,
    gated_conv,
    init_weights,
    recording_conv_inputs,
    update_running_stats,
)

__all__ = ["ConvBlock", "ConvNormAct", "DoubleConv", "DoubleConvMid", "Down", "DownSample",
           "Int8Conv", "OutConv", "ResidualConv", "TransposedUp", "UpBilinear",
           "UpConvBlock", "UpSampleUNet", "ZooDoubleConv", "attach_int8", "batch_norm", "conv",
           "conv_norm_act", "conv_transpose", "double_conv_norm_act", "gated_conv", "init_weights",
           "recording_conv_inputs", "update_running_stats"]
