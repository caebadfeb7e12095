"""Inference/serving helpers.

``make_predictor`` builds a predictor for a trained model: parameters
rounded to bfloat16 (batch statistics stay float32), the decoder's kernel
weights folded and packed once, optionally int8 convs from the statistics of
``calibrate_int8``, and optional sigmoid/threshold and flip test-time
augmentation. Counterpart of ``unet_zoo_tpu/utils/serving.py``.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch
from torch import nn

from unet_zoo_tpu_torch.models import ZooModel
from unet_zoo_tpu_torch.nn import attach_int8, recording_conv_inputs

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


def calibrate_int8(model: ZooModel, batches: Iterable[torch.Tensor],
                   state: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Post-training-quantisation calibration for int8 serving (counterpart
    of ``unet_zoo_tpu/utils/serving.py:32-63``).

    Runs eval forwards of the float module path (no kernels, no int8) over
    ``batches`` (NCHW images) with ``state`` (default: the module's own
    weights), records each int8-gated conv's input absmax in float32 and
    takes the maximum across batches. Returns ``{conv module name: absmax}``
    (0-dim float32 tensors), the statistics ``make_predictor(quant=...)``
    serves int8 with; the float ``state_dict`` is untouched.
    """
    net = copy.deepcopy(model.module).eval()
    if state is not None:
        net.load_state_dict(state, strict=True)
    for m in net.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = False
        if hasattr(m, "int8"):
            del m.int8
    device = next(net.parameters()).device
    names = {m: n for n, m in net.named_modules()}
    stats: Optional[Dict[str, torch.Tensor]] = None
    for x in batches:
        with torch.inference_mode(), recording_conv_inputs() as rec:
            net(x.to(device=device, memory_format=torch.channels_last))
        if not rec:
            raise ValueError(
                f"model '{model.name}' has no quantizable convs (none of "
                "its compute routes through the int8-gated conv blocks)")
        got = {names[m]: v for m, v in rec.items()}
        stats = got if stats is None else {k: torch.maximum(stats[k], v) for k, v in got.items()}
    if stats is None:
        raise ValueError("calibrate_int8 needs at least one batch")
    return stats


def make_predictor(
    model: ZooModel,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    output: str = "logits",   # 'logits' | 'probs' | 'mask'
    threshold: float = 0.5,
    cast_bf16: bool = True,
    tta: bool = False,
    quant: Optional[Mapping[str, torch.Tensor]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``predict(images [B, C, H, W]) -> main output`` closure.

    ``state`` is a ``state_dict`` to serve (default: the module's own
    weights). ``output='mask'`` returns the thresholded mask (uint8),
    ``'probs'`` the sigmoid probabilities (float32), ``'logits'`` raw
    logits. ``tta=True`` averages probabilities over the four H/V flips
    (each un-flipped first), run as one 4x batch; it rejects ``'logits'``.
    ``quant`` (from :func:`calibrate_int8`) serves those convs int8: their
    served weights (bf16-rounded when ``cast_bf16``) are quantised once,
    here, as JAX folds them into the program at trace time. The predictor
    works on a frozen copy of the module (``predict.module``): later changes
    to ``model`` do not reach it.
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
    if quant is not None:
        attach_int8(net, quant)
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

    predict.module = net
    return predict
