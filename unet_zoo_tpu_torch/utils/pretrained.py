"""Pretrained weights for RAUNet's ResNet-34 encoder, read without JAX.

The JAX package vendors a flax-serialized encoder
(``unet_zoo_tpu/pretrained/raunet_encoder_synthetic.msgpack``: nested maps
of str keys, the arrays as msgpack ext type 1, float16 parameters and
float32 batch statistics, and a ``meta`` map of strs). ``msgpack_restore``
decodes such a file with no ``msgpack`` or ``flax`` package: maps, strs,
bins, exts, arrays, ints, nil and bools; any other type, or an ext of
another code, raises. ``vendored_encoder`` and ``torchvision_encoder`` turn
the decoded tree, or a torchvision ``resnet34`` ``.pth``, into the port's
encoder keys (``nn/resnet.py``), float32.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

# flax.serialization's ext code of an ndarray: (shape, dtype name, C-order bytes)
EXT_NDARRAY = 1
# the vendored encoder, read from its place in the repo
VENDORED_RAUNET_ENCODER = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "unet_zoo_tpu", "pretrained",
    "raunet_encoder_synthetic.msgpack")


class _Reader:
    """A cursor over msgpack bytes; :meth:`value` decodes the next object."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: {n} bytes wanted at {self.pos}, "
                             f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> int:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        at = self.pos
        t = self.unpack("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        ints = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i",
                0xD3: "q"}
        if t in ints:
            return self.unpack(ints[t])
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
                 0xDC: ("array", "H"), 0xDD: ("array", "I"),
                 0xDE: ("map", "H"), 0xDF: ("map", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I")}
        if t in sized:
            kind, fmt = sized[t]
            return getattr(self, kind)(self.unpack(fmt))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"msgpack: type byte {t:#04x} at {at} is not one this reader takes")

    def map(self, n: int) -> Dict[Any, Any]:
        return {self.value(): self.value() for _ in range(n)}

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack("b")
        at = self.pos
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack: ext code {code} at {at} is not flax's ndarray "
                             f"({EXT_NDARRAY})")
        inner = _Reader(self.take(n))
        shape, dtype, buf = inner.value()
        if inner.pos != n or not isinstance(buf, bytes):
            raise ValueError(f"msgpack: the ndarray at {at} is not (shape, dtype, bytes)")
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """The object that ``flax.serialization.msgpack_restore`` decodes from
    ``data``: arrays as read-only numpy arrays of the stored shape and
    dtype, bins as ``bytes``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - reader.pos} bytes after the object")
    return out


def _conv(a) -> np.ndarray:
    return np.asarray(a).transpose(3, 2, 0, 1)          # HWIO -> OIHW


def _bn(sd, key, p, s) -> None:
    sd[f"{key}.weight"], sd[f"{key}.bias"] = p["scale"], p["bias"]
    sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = s["mean"], s["var"]


def from_jax_encoder(params, batch_stats) -> Dict[str, np.ndarray]:
    """JAX ``ResNet34Encoder`` variables (``conv1``, ``bn1``,
    ``layer{l}_{b}`` with ``Conv_{0,1}``, ``BatchNorm_{0,1}``,
    ``downsample_{conv,bn}``) -> the port's encoder keys, numpy values in
    their stored dtype."""
    sd: Dict[str, np.ndarray] = {"firstconv.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, "firstbn", params["bn1"], batch_stats["bn1"])
    for name, p in params.items():
        if not name.startswith("layer"):
            continue
        layer, block = name[len("layer"):].split("_")
        t, s = f"encoder{layer}.{block}", batch_stats[name]
        for i in (0, 1):
            sd[f"{t}.conv{i + 1}.weight"] = _conv(p[f"Conv_{i}"]["kernel"])
            _bn(sd, f"{t}.bn{i + 1}", p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"])
        if "downsample_conv" in p:
            sd[f"{t}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            _bn(sd, f"{t}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    return sd


def from_torchvision_resnet34(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A torchvision ``resnet34`` state_dict (``module.`` prefixes stripped
    already) -> the port's encoder keys: ``conv1``/``bn1`` -> ``firstconv``/
    ``firstbn``, ``layer{l}`` -> ``encoder{l}``; the head (``fc.*``) and
    ``num_batches_tracked`` are left out."""
    out = {}
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        if k.startswith("conv1."):
            k = "firstconv." + k[len("conv1."):]
        elif k.startswith("bn1."):
            k = "firstbn." + k[len("bn1."):]
        elif k.startswith("layer"):
            k = "encoder" + k[len("layer"):]
        else:
            raise ValueError(f"{k} is not a key of torchvision's resnet34")
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def vendored_encoder(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """The vendored encoder at ``path`` as the port's encoder keys (float32
    tensors) and its ``meta`` map; decoded once per path (every caller gets
    the same tensors: read them, do not write them)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    sd = from_jax_encoder(tree["params"], tree["batch_stats"])
    return ({k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()},
            dict(tree.get("meta", {})))


def torchvision_encoder(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet34`` state_dict saved at ``path`` (``module.``
    prefixes stripped) as the port's encoder keys, float32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return {k: torch.as_tensor(v).float() for k, v in from_torchvision_resnet34(sd).items()}
