"""Best and last checkpoints with the whole training state.

Counterpart of ``unet_zoo_tpu/utils/checkpoint.py``: the same payload keys
(``variables`` the module's ``state_dict``, ``opt_state`` the AdamW
``state_dict``, ``step``, and the JSON-able ``meta``, ``scheduler`` and
``early_stopping``) and one directory per checkpoint. Tensors go to
``arrays.pt`` by ``torch.save``, on the host, and the rest to
``extra.json`` beside it. :func:`load_checkpoint` reads under
``torch.load(weights_only=True)`` and returns host tensors.

In a multi-process run every rank calls both: saving gathers sharded
tensors (FSDP's) whole on every rank, a collective, and only the primary
writes, then all wait for it; loading waits for every rank first, then each
reads. A checkpoint holds whole tensors, so it restores on any topology.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

from unet_zoo_tpu_torch.parallel.multihost import (
    fully_replicate_to_host,
    is_primary,
    sync_global_devices,
)

_ARRAY_KEYS = ("variables", "opt_state", "step")
_ARRAYS_FILE = "arrays.pt"
_EXTRA_FILE = "extra.json"


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` to the directory ``path``, replacing what was there
    (the primary process; every rank calls it)."""
    path = os.path.abspath(path)
    arrays = {k: fully_replicate_to_host(payload[k]) for k in _ARRAY_KEYS if k in payload}
    if is_primary():
        os.makedirs(path, exist_ok=True)
        extra = {k: v for k, v in payload.items() if k not in _ARRAY_KEYS}
        tmp = os.path.join(path, _ARRAYS_FILE + ".tmp")
        torch.save(arrays, tmp)
        os.replace(tmp, os.path.join(path, _ARRAYS_FILE))
        with open(os.path.join(path, _EXTRA_FILE), "w") as f:
            json.dump(extra, f)
    sync_global_devices("save_checkpoint")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload saved at ``path``, tensors on the host."""
    sync_global_devices("load_checkpoint")
    path = os.path.abspath(path)
    out = dict(torch.load(os.path.join(path, _ARRAYS_FILE), map_location="cpu",
                          weights_only=True))
    extra_path = os.path.join(path, _EXTRA_FILE)
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            out.update(json.load(f))
    return out


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(os.path.join(os.path.abspath(path), _ARRAYS_FILE))
