"""Inference/serving helpers.

``make_predictor`` builds a predictor for a trained model: parameters
rounded to bfloat16 (batch statistics stay float32), the decoder's kernel
weights folded and packed once, and optional sigmoid/threshold and flip
test-time augmentation. Counterpart of ``unet_zoo_tpu/utils/serving.py``.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.models import ZooModel

_OUTPUTS = ("logits", "probs", "mask")


def cast_params_for_inference(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """A copy of ``module`` with every floating parameter cast to ``dtype``.

    Buffers (BatchNorm's running mean and variance) stay float32, as the
    JAX package leaves ``batch_stats`` alone. Blocks cast parameters to
    their compute type at use, so on a float32 model this rounds the
    weights and keeps the arithmetic in float32.
    """
    out = copy.deepcopy(module)
    for p in out.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return out


def make_predictor(
    model: ZooModel,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    output: str = "logits",   # 'logits' | 'probs' | 'mask'
    threshold: float = 0.5,
    cast_bf16: bool = True,
    tta: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``predict(images [B, C, H, W]) -> main output`` closure.

    ``state`` is a ``state_dict`` to serve (default: the module's own
    weights). ``output='mask'`` returns the thresholded mask (uint8),
    ``'probs'`` the sigmoid probabilities (float32), ``'logits'`` raw
    logits. ``tta=True`` averages probabilities over the four H/V flips
    (each un-flipped first), run as one 4x batch; it rejects ``'logits'``.
    The predictor works on a frozen copy of the module: later changes to
    ``model`` do not reach it.
    """
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {_OUTPUTS}, got {output!r}")
    if tta and output == "logits":
        raise ValueError("tta averages probabilities; use output='probs' "
                         "or 'mask' (mean-of-logits is not the ensemble)")
    net = cast_params_for_inference(model.module) if cast_bf16 else copy.deepcopy(model.module)
    if state is not None:
        net.load_state_dict(state, strict=True)  # rounds into the cast parameters
    net.eval()
    for m in net.modules():
        if hasattr(m, "freeze_kernel_weights"):
            m.freeze_kernel_weights()
    device = next(net.parameters()).device

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        x = images.to(device=device, memory_format=torch.channels_last)
        if tta:
            b = x.shape[0]
            variants = torch.cat([x, x.flip(2), x.flip(3), x.flip(2, 3)], dim=0)
            p = torch.sigmoid(net(variants)["main"].float())
            probs = (p[:b] + p[b:2 * b].flip(2) + p[2 * b:3 * b].flip(3)
                     + p[3 * b:].flip(2, 3)) * 0.25
        else:
            logits = net(x)["main"]
            if output == "logits":
                return logits
            probs = torch.sigmoid(logits.float())
        if output == "probs":
            return probs
        return (probs > threshold).to(torch.uint8)

    return predict
