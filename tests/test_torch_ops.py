"""The port's ops and package surface against the JAX package (CPU).

Inputs are made with numpy from a seed; the JAX functions are the oracle.
Layouts: JAX is NHWC, the port NCHW (channels_last in memory).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.ops import max_pool2d as jax_max_pool2d
from unet_zoo_tpu.ops import pad_to_match as jax_pad_to_match
from unet_zoo_tpu_torch.ops import max_pool2d, pad_to_match

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("hw,target", [
    ((5, 7), (8, 9)),     # odd pads: floor low, rest high
    ((6, 6), (6, 6)),     # no-op
    ((9, 8), (6, 8)),     # negative diff: center crop
    ((7, 4), (4, 9)),     # crop one dim, pad the other
])
def test_pad_to_match_matches_jax(hw, target):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_pad_to_match(jnp.asarray(x), target))
    got = _nhwc(pad_to_match(_nchw(x), target))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 5), (9, 4)])
def test_max_pool2d_matches_jax(hw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 4)).astype(np.float32)
    ref = np.asarray(jax_max_pool2d(jnp.asarray(x), 2))
    got = _nhwc(max_pool2d(_nchw(x).contiguous(memory_format=torch.channels_last), 2))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_import_leaves_jax_out():
    code = ("import sys, unet_zoo_tpu_torch, unet_zoo_tpu_torch.utils.serving, "
            "unet_zoo_tpu_torch.utils.convert; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'unet_zoo_tpu') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_create_model_without_cuda_raises(monkeypatch):
    from unet_zoo_tpu_torch import create_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model("unet")


def test_registry_surface():
    from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
    from unet_zoo_tpu_torch import create_model, get_model_config, list_models

    assert list_models() == ["unet"]
    assert get_model_config("unet") == {}
    m = create_model("unet", device="cpu", use_pallas=False, in_channels=1, num_classes=2)
    assert (m.in_channels, m.num_classes, m.image_size) == (1, 2, None)
    assert m.module.up_convolution_1.use_kernels is False
    jax_spec = JAX_REGISTRY["unet"]
    for key in ("main", "side1"):
        assert m.loss_weight(key) == jax_spec.loss_weight(key)
    with pytest.raises(ValueError, match="not both"):
        create_model("unet", device="cpu", use_pallas=True, use_kernels=True)
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("attention_unet", device="cpu")
