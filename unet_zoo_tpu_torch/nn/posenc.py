"""2D sinusoidal positional encoding (NCHW).

Counterpart of ``unet_zoo_tpu/nn/posenc.py``: the table is built once per
``(h, w, c)`` in numpy (float32) and cast to the input's type and device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def sincos_table(h: int, w: int, orig_ch: int) -> np.ndarray:
    """``PositionalEncoding2D`` of the original zoo's U-Transformer: the
    first half of the channels encodes the H coordinate, the second half the
    W coordinate, truncated to ``orig_ch``. Returns [orig_ch, h, w] float32
    (JAX ``_sincos_2d``, transposed to channels first)."""
    channels = int(np.ceil(orig_ch / 2))
    inv_freq = 1.0 / (10000 ** (np.arange(0, channels, 2, dtype=np.float32) / channels))
    sin_h = np.einsum("i,j->ij", np.arange(h, dtype=np.float32), inv_freq)
    sin_w = np.einsum("i,j->ij", np.arange(w, dtype=np.float32), inv_freq)
    emb_h = np.concatenate([np.sin(sin_h), np.cos(sin_h)], axis=-1)   # [h, ~channels]
    emb_w = np.concatenate([np.sin(sin_w), np.cos(sin_w)], axis=-1)   # [w, ~channels]
    emb = np.zeros((h, w, channels * 2), dtype=np.float32)
    emb[:, :, :channels] = emb_h[:, None, :channels]
    emb[:, :, channels:2 * channels] = emb_w[None, :, :channels]
    table = np.ascontiguousarray(emb[:, :, :orig_ch].transpose(2, 0, 1))
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=64)
def _device_table(h: int, w: int, c: int, device: torch.device, dtype: torch.dtype
                  ) -> torch.Tensor:
    # a normal tensor even when first asked for inside inference_mode, so that
    # a training forward may use it later; channels_last, as the maps it is
    # added to, so that the add runs vectorised
    with torch.inference_mode(False):
        table = torch.from_numpy(sincos_table(h, w, c).copy()).to(device, dtype)[None]
        return table.contiguous(memory_format=torch.channels_last)


def sincos_posenc_2d(x: torch.Tensor) -> torch.Tensor:
    """The positional encoding matching NCHW ``x``, [1, C, H, W] in
    ``x.dtype`` on ``x.device`` (channels_last memory), broadcastable over
    the batch (copied to the device once per shape, type and device)."""
    _, c, h, w = x.shape
    return _device_table(h, w, c, x.device, x.dtype)
