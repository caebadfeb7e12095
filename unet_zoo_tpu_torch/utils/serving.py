"""Inference/serving helpers.

``make_predictor`` builds a predictor for a trained model: parameters
rounded to bfloat16 (batch statistics stay float32), the decoder's kernel
weights folded and packed once, optionally int8 convs from the statistics of
``calibrate_int8``, and optional sigmoid/threshold and flip test-time
augmentation. ``make_tiled_predictor`` serves images larger than the model
by Hann-blended sliding windows; ``export_predictor`` writes a predictor as a
``torch.export`` program that carries the hand-written kernels as ops, and
``load_predictor`` runs one without the model code. Counterpart of
``unet_zoo_tpu/utils/serving.py``.
"""

from __future__ import annotations

import copy
import io
import math
import os
from typing import Callable, Dict, Iterable, Mapping, Optional, Union

import torch
import torch.nn.functional as F
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


def _post(logits: torch.Tensor, output: str, threshold: float) -> torch.Tensor:
    """Float32 logits -> the predictor's output kind."""
    if output == "logits":
        return logits
    probs = torch.sigmoid(logits)
    if output == "probs":
        return probs
    return (probs > threshold).to(torch.uint8)


class ServedModule(nn.Module):
    """A served module and its output step as one module: images [B, C, H,
    W] -> channels-last memory -> the net's main logits (in the net's
    compute type) or :func:`_post` of them in float32. :func:`make_predictor`
    runs it (without test-time augmentation) and :func:`export_predictor`
    exports it."""

    def __init__(self, net: nn.Module, output: str, threshold: float):
        super().__init__()
        self.net = net
        self.output = output
        self.threshold = threshold

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        logits = self.net(images.contiguous(memory_format=torch.channels_last))["main"]
        if self.output == "logits":
            return logits
        return _post(logits.float(), self.output, self.threshold)


def make_predictor(
    model: ZooModel,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    output: str = "logits",   # 'logits' | 'probs' | 'mask'
    threshold: float = 0.5,
    cast_bf16: bool = True,
    tta: bool = False,
    quant: Optional[Mapping[str, torch.Tensor]] = None,
    mesh=None,
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
    works on a frozen copy of the module (``predict.module``; with its
    output step, ``predict.served``): later changes to ``model`` do not
    reach it.

    With a ``mesh`` (``parallel.create_mesh``) every rank calls ``predict``
    on the same global batch: the served weights are rank 0's on every
    rank, each rank runs its rows of the batch (batch statistics, such as
    vnet's, over the global batch) and every rank returns the whole batch's
    output, gathered, as JAX returns one global array.
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
    served = ServedModule(net, output, threshold)

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        x = images.to(device=device, memory_format=torch.channels_last)
        if not tta:
            return served(x)
        b = x.shape[0]
        variants = torch.cat([x, x.flip(2), x.flip(3), x.flip(2, 3)], dim=0)
        p = torch.sigmoid(net(variants)["main"].float())
        probs = (p[:b] + p[b:2 * b].flip(2) + p[2 * b:3 * b].flip(3) + p[3 * b:].flip(2, 3)) * 0.25
        return probs if output == "probs" else (probs > threshold).to(torch.uint8)

    predict.module = net
    predict.served = served
    if mesh is None:
        return predict
    return _sharded(predict, net, mesh)


def _sharded(predict, net: nn.Module, mesh):
    """``predict`` over ``mesh``: rank 0's weights, this rank's rows of each
    global batch, the whole output gathered on every rank."""
    from unet_zoo_tpu_torch.parallel import global_batch_statistics, replicate_state, shard_batch
    from unet_zoo_tpu_torch.parallel.mesh import data_group_of

    replicate_state(mesh, net)
    group = data_group_of(mesh)

    @torch.inference_mode()
    def predict_sharded(images: torch.Tensor) -> torch.Tensor:
        with global_batch_statistics(group):
            local = predict(shard_batch(mesh, images)).contiguous()
        out = local.new_empty((local.shape[0] * torch.distributed.get_world_size(group),
                               *local.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, local, group=group)
        return out

    predict_sharded.module, predict_sharded.served = predict.module, predict.served
    return predict_sharded


def hann_window(tile: int) -> torch.Tensor:
    """The separable Hann blend window [tile, tile], float32, strictly
    positive: ``w1 = 0.5 - 0.5 cos(2 pi (i + 0.5) / tile)`` (the half-sample
    offset keeps the edges off zero), ``outer(w1, w1) + 1e-6``, as the JAX
    package computes it in float64 and rounds once."""
    i = torch.arange(tile, dtype=torch.float64)
    w1 = 0.5 - 0.5 * torch.cos(2.0 * math.pi * (i + 0.5) / tile)
    return (torch.outer(w1, w1) + 1e-6).float()


def tile_grid(h: int, w: int, tile: int, stride: int):
    """The sliding-window layout of an H x W image: (n_h, n_w, Hp, Wp, pad
    mode); the padded Hp x Wp holds n_h x n_w tiles ``stride`` apart. Reflect
    padding needs a pad smaller than the image, so a small image pads its
    edge (JAX's ``edge``, torch's ``replicate``)."""
    n_h = max(1, -(-(max(h, tile) - tile) // stride) + 1)
    n_w = max(1, -(-(max(w, tile) - tile) // stride) + 1)
    hp, wp = (n_h - 1) * stride + tile, (n_w - 1) * stride + tile
    mode = "reflect" if hp - h < h and wp - w < w else "replicate"
    return n_h, n_w, hp, wp, mode


def make_tiled_predictor(
    model: ZooModel,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    tile: int = 512,
    overlap: float = 0.25,
    output: str = "logits",   # 'logits' | 'probs' | 'mask'
    threshold: float = 0.5,
    tile_batch: int = 8,
    cast_bf16: bool = True,
    quant: Optional[Mapping[str, torch.Tensor]] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Sliding-window predictor for images larger than the model's size
    (counterpart of ``unet_zoo_tpu/utils/serving.py:140-242``): the model
    runs on overlapping ``tile`` x ``tile`` windows ``round(tile (1 -
    overlap))`` apart and the float32 logits are blended with the separable
    Hann window (:func:`hann_window`): a weighted sum over tiles divided by
    the summed weights, cropped to H x W. The image is padded at the bottom
    and right to whole tiles (:func:`tile_grid`).

    Tiles go through the frozen served module of :func:`make_predictor`
    (``state``, ``cast_bf16`` and ``quant`` as there, so the decoder runs
    K1 and int8 convs P2 on the card) ``tile_batch`` at a time, in
    channels-last memory; a last short chunk is filled with copies of the
    image's first tile, as JAX does, so every forward has one shape (the
    copies add the same weighted tile to the sums and the weights, which
    the division cancels). Only the [B, K, Hp, Wp] float32 canvas and its
    weights outlive a chunk. ``predict(images [B, C, H, W])`` returns [B, K,
    H, W] logits (float32), probabilities or a uint8 mask.
    """
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {_OUTPUTS}, got {output!r}")
    if not 0.0 <= overlap < 1.0:
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    stride = max(1, int(round(tile * (1.0 - overlap))))
    served = make_predictor(model, state, "logits", cast_bf16=cast_bf16, quant=quant)
    net = served.module
    device = next(net.parameters()).device
    win = hann_window(tile).to(device)

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        b, c, h, w = images.shape
        n_h, n_w, hp, wp, mode = tile_grid(h, w, tile, stride)
        x = images.to(device=device, dtype=torch.float32)
        if hp > h or wp > w:
            x = F.pad(x, (0, wp - w, 0, hp - h), mode=mode)
        pos = [(i, y * stride, xx * stride) for i in range(b) for y in range(n_h)
               for xx in range(n_w)]
        tb = max(1, min(tile_batch, len(pos)))
        pos += [pos[0]] * ((-len(pos)) % tb)
        out = wsum = None
        for k in range(0, len(pos), tb):
            chunk = pos[k:k + tb]
            tiles = torch.stack([x[i, :, y:y + tile, xx:xx + tile] for i, y, xx in chunk])
            logits = net(tiles.contiguous(memory_format=torch.channels_last))["main"].float()
            if out is None:
                out = torch.zeros(b, logits.shape[1], hp, wp, device=device)
                wsum = torch.zeros(b, 1, hp, wp, device=device)
            for j, (i, y, xx) in enumerate(chunk):
                out[i, :, y:y + tile, xx:xx + tile] += logits[j] * win
                wsum[i, :, y:y + tile, xx:xx + tile] += win
        return _post((out / wsum)[:, :, :h, :w], output, threshold)

    predict.module = net
    return predict


def export_predictor(
    model: ZooModel,
    state: Optional[Mapping[str, torch.Tensor]] = None,
    batch: int = 8,
    image_size: int = 256,
    in_channels: int = 3,
    output: str = "logits",
    threshold: float = 0.5,
    cast_bf16: bool = True,
    quant: Optional[Mapping[str, torch.Tensor]] = None,
    path: Optional[Union[str, os.PathLike]] = None,
) -> bytes:
    """Serialise a predictor (the cast, optional int8 convs, the forward and
    the sigmoid/threshold, at the fixed shape [batch, in_channels,
    image_size, image_size] on the model's device) as a ``torch.export``
    program (counterpart of ``unet_zoo_tpu/utils/serving.py:246``). The
    program holds the weights, K1's packed weights and the int8 weights as
    its own tensors, and the kernels as the ops ``unet_zoo::
    fused_up_concat_conv`` and ``unet_zoo::int8_conv``, so loaded on the
    card it launches them. A forward that reaches a kernel that is not an op
    yet (K2-K6 and K8 on the card, or with ``use_kernels=True``) raises,
    naming it: the plain version is never exported in a kernel's place; a
    model built with ``use_kernels=False`` exports its plain path. Returns
    the ``torch.export.save`` bytes, also written to ``path`` when given.
    """
    if output not in _OUTPUTS:
        raise ValueError(f"output must be one of {_OUTPUTS}, got {output!r}")
    served = make_predictor(model, state, output, threshold, cast_bf16, quant=quant).served
    device = next(served.parameters()).device
    example = torch.zeros(batch, in_channels, image_size, image_size, device=device)
    program = torch.export.export(served, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_predictor(blob_or_path: Union[bytes, str, os.PathLike]
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Rehydrate an exported predictor (counterpart of
    ``unet_zoo_tpu/utils/serving.py:279``): a callable ``predict(images)``
    that moves the images to the program's device and runs it in inference
    mode. Needs only ``torch`` and ``unet_zoo_tpu_torch.ops.kernels``, whose
    import registers the kernels' ops; no model code. The program's module
    is ``predict.module``."""
    src = io.BytesIO(blob_or_path) if isinstance(blob_or_path, (bytes, bytearray)) \
        else blob_or_path
    module = torch.export.load(src).module()
    device = next(iter(module.state_dict().values())).device

    def predict(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(images.to(device))

    predict.module = module
    return predict
