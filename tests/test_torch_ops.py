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

from unet_zoo_tpu.ops import avg_pool2d as jax_avg_pool2d
from unet_zoo_tpu.ops import max_pool2d as jax_max_pool2d
from unet_zoo_tpu.ops import pad_to_match as jax_pad_to_match
from unet_zoo_tpu.ops import resize_bilinear as jax_resize_bilinear
from unet_zoo_tpu_torch.ops import avg_pool2d, max_pool2d, pad_to_match, resize_bilinear

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


@pytest.mark.parametrize("hw", [(7, 9), (6, 6), (5, 3)])
@pytest.mark.parametrize("window,padding", [(7, 3), (3, 1)])
def test_padded_max_pool2d_matches_jax(hw, window, padding):
    """Stride-1 padded pools as mmunet's morphology uses them (-inf padding);
    erosion is -max_pool2d(-x)."""
    x = np.random.default_rng(2).standard_normal((2, *hw, 4)).astype(np.float32)
    for sign in (1.0, -1.0):
        ref = sign * np.asarray(jax_max_pool2d(jnp.asarray(sign * x), window, 1, padding))
        got = sign * _nhwc(max_pool2d(_nchw(sign * x).contiguous(memory_format=torch.channels_last),
                                      window, 1, padding))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw,window,stride,padding", [
    ((8, 8), 2, None, 0),    # the stride-2 axial blocks
    ((7, 9), 2, None, 0),    # odd sizes: floor mode drops the last row/column
    ((5, 6), 3, 2, 1),       # zero padding counted in the window area
    ((9, 4), 3, 1, 0),
])
def test_avg_pool2d_matches_jax(hw, window, stride, padding):
    """Float32 sums over the window area on both sides; the bf16 case
    rounds the same float32 mean once: 1e-6, and bf16-exact."""
    x = np.random.default_rng(4).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_avg_pool2d(jnp.asarray(x), window, stride, padding))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    got = _nhwc(avg_pool2d(xt, window, stride, padding))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    ref16 = jax_avg_pool2d(jnp.asarray(x).astype(jnp.bfloat16), window, stride, padding)
    got16 = avg_pool2d(xt.to(torch.bfloat16), window, stride, padding)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got16.float()), np.asarray(ref16.astype(jnp.float32)))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw,size", [
    ((5, 7), (10, 14)),   # mmunet's 2x upsample at odd sizes
    ((8, 8), (16, 16)),
    ((9, 4), (5, 11)),    # down in one dim, up in the other
    ((6, 6), (6, 6)),     # no-op
    ((1, 3), (2, 6)),     # a single row
])
def test_resize_bilinear_matches_jax(hw, size, align_corners):
    """ATen against the JAX package's interpolation matmuls, float32: 1e-5."""
    x = np.random.default_rng(3).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), size, align_corners=align_corners))
    got = _nhwc(resize_bilinear(_nchw(x).contiguous(memory_format=torch.channels_last),
                                size, align_corners=align_corners))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_import_leaves_jax_out():
    code = ("import sys, unet_zoo_tpu_torch, unet_zoo_tpu_torch.utils.serving, "
            "unet_zoo_tpu_torch.utils.convert, unet_zoo_tpu_torch.ops.quant, "
            "unet_zoo_tpu_torch.ops.kernels.int8_gemm, unet_zoo_tpu_torch.ops.kernels.row_gather, "
            "unet_zoo_tpu_torch.models.unet_tpu, unet_zoo_tpu_torch.probes.int8_matmul, "
            "unet_zoo_tpu_torch.probes.gather, unet_zoo_tpu_torch.probes.int8_conv_plan, "
            "unet_zoo_tpu_torch.probes.medt_paths, unet_zoo_tpu_torch.probes.gated_step, "
            "unet_zoo_tpu_torch.probes.mkblock_grids; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'unet_zoo_tpu') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_create_model_without_cuda_raises(monkeypatch):
    from unet_zoo_tpu_torch import create_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("unet", "mmunet"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model(name)


def test_registry_surface():
    from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
    from unet_zoo_tpu_torch import create_model, get_model_config, list_models

    assert list_models() == ["attention_unet", "axialunet", "da_transformer", "egeunet",
                             "gated", "logo", "medt", "medt_logo", "missformer", "mmunet",
                             "multiresunet", "nested_unet", "raunet", "resunet", "swin_unet_v2",
                             "transatt_unet", "u2net", "u2net_tpu", "u2netp", "uctransnet",
                             "unet", "unet_tpu", "unet_transformer", "unext", "unext_moe",
                             "unext_s", "vnet", "wranet"]
    assert get_model_config("unet") == {} and get_model_config("mmunet") == {}
    m = create_model("unet", device="cpu", use_pallas=False, in_channels=1, num_classes=2)
    assert (m.in_channels, m.num_classes, m.image_size) == (1, 2, None)
    assert m.module.up_convolution_1.use_kernels is False
    mm = create_model("mmunet", device="cpu", use_pallas=True, base_channels=16, num_classes=2)
    assert (mm.in_channels, mm.num_classes, mm.image_size) == (3, 2, None)
    assert mm.module.up5.conv[0].use_kernels is True and mm.module.up1.use_kernels is True
    assert mm.module.first_down[0].out_channels == 16 and mm.module.down3[0].out_channels == 128
    tp = create_model("unet_tpu", device="cpu", widths=(16, 32, 32, 32), use_pallas=False)
    assert tp.module.enc0.use_kernels is False and tp.module.down2.use_kernels is False
    for name, model in (("unet", m), ("mmunet", mm), ("unet_tpu", tp)):
        jax_spec = JAX_REGISTRY[name]
        assert (model.spec.requires_image_size, model.spec.default_image_size) == (
            jax_spec.requires_image_size, jax_spec.default_image_size)
        for key in ("main", "side1"):
            assert model.loss_weight(key) == jax_spec.loss_weight(key)
    with pytest.raises(ValueError, match="not both"):
        create_model("unet", device="cpu", use_pallas=True, use_kernels=True)
    from unet_zoo_tpu_torch.models import _REGISTRY

    for name in ("attention_unet", "nested_unet", "resunet", "u2net", "u2netp", "u2net_tpu",
                 "raunet", "transatt_unet", "unet_transformer", "multiresunet", "vnet"):
        assert get_model_config(name) == {}
        for key in ("main", "side1", "side4"):
            assert _REGISTRY[name].loss_weight(key) == JAX_REGISTRY[name].loss_weight(key)
        assert (_REGISTRY[name].requires_image_size, _REGISTRY[name].default_image_size,
                _REGISTRY[name].pretrained_by_default) == (
            JAX_REGISTRY[name].requires_image_size, JAX_REGISTRY[name].default_image_size,
            JAX_REGISTRY[name].pretrained_by_default)
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("transunet", device="cpu")
