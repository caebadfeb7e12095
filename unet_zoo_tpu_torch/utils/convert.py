"""Weights from the JAX package into the port.

``from_jax_variables(model_name, variables)`` takes a JAX variables tree
``{'params', 'batch_stats'}`` (leaves as numpy arrays, or anything
``np.asarray`` reads) and returns a ``state_dict`` that the port's module
loads with ``strict=True``. It is the inverse of the JAX package's
``utils/convert.py`` readers, kept as the port's own copy:

* conv: HWIO -> OIHW;
* ConvTranspose: Flax applies the kernel spatially flipped, so
  ``torch_w = flip(flax_k, axes 0, 1).transpose(2, 3, 0, 1)``;
* BatchNorm: scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a contiguous, writable copy


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv_transpose(sd, key, p):
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"])[::-1, ::-1], (2, 3, 0, 1)))
    sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd, key, p, s):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _double_conv(sd, prefix, p, s):
    for i, idx in enumerate((0, 3)):
        cna, st = p[f"ConvNormAct_{i}"], s[f"ConvNormAct_{i}"]
        _conv(sd, f"{prefix}.{idx}", cna["Conv_0"])
        _bn(sd, f"{prefix}.{idx + 1}", cna["BatchNorm_0"], st["BatchNorm_0"])


def _unet(variables) -> Dict[str, torch.Tensor]:
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(4):
        _double_conv(sd, f"down_convolution_{i + 1}.conv.conv_op",
                     p[f"DownSample_{i}"]["DoubleConv_0"], s[f"DownSample_{i}"]["DoubleConv_0"])
    _double_conv(sd, "bottle_neck.conv_op", p["DoubleConv_0"], s["DoubleConv_0"])
    for i in range(4):
        up_p, up_s = p[f"UpSampleUNet_{i}"], s[f"UpSampleUNet_{i}"]
        _conv_transpose(sd, f"up_convolution_{i + 1}.up",
                        up_p["TransposedUp_0"]["ConvTranspose_0"])
        _double_conv(sd, f"up_convolution_{i + 1}.conv.conv_op",
                     up_p["DoubleConv_0"], up_s["DoubleConv_0"])
    _conv(sd, "out.conv", p["OutConv_0"]["Conv_0"])
    return sd


CONVERTERS: Dict[str, Callable[[Any], Dict[str, torch.Tensor]]] = {"unet": _unet}


def from_jax_variables(model_name: str, variables) -> Dict[str, torch.Tensor]:
    """JAX variables ``{'params', 'batch_stats'}`` -> the port's ``state_dict``."""
    name = model_name.lower()
    if name not in CONVERTERS:
        raise ValueError(f"No converter for '{model_name}'. Available: {sorted(CONVERTERS)}")
    return CONVERTERS[name](variables)
