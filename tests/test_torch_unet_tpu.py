"""unet_tpu in the port against the JAX package (CPU, float32), with the JAX
weights carried over by ``from_jax_variables``: both heads, one and two
classes, an input size the stem does not divide, the registry-default widths;
and the nearest resizes of ``ops/resize.py``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.ops import resize as jax_resize
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.ops import resize_nearest, upsample2x_nearest
from unet_zoo_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

CL = torch.channels_last
NARROW = (16, 32, 32, 32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _perturb(rng, params, stats):
    """BN statistics and affine off identity and every conv bias off zero."""
    for k, sub in params.items():
        if k in stats and "mean" in stats[k]:
            stats[k]["mean"] = rng.standard_normal(stats[k]["mean"].shape).astype(np.float32) * 0.1
            stats[k]["var"] = (rng.random(stats[k]["var"].shape) + 0.5).astype(np.float32)
            sub["scale"] = (rng.random(sub["scale"].shape) + 0.5).astype(np.float32)
            sub["bias"] = rng.standard_normal(sub["bias"].shape).astype(np.float32) * 0.1
        elif "kernel" in sub and "bias" in sub:
            sub["bias"] = rng.standard_normal(sub["bias"].shape).astype(np.float32) * 0.1
        elif isinstance(sub, dict):
            _perturb(rng, sub, stats.get(k, {}))


def _pair(h, w, seed=0, **kw):
    """JAX unet_tpu variables (perturbed), its jitted eval logits on a seeded
    batch, and the port's model with the same weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    m = jax_create_model("unet_tpu", **kw)
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        m.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))))
    _perturb(rng, v["params"], v["batch_stats"])
    want = np.asarray(jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])(
        v, jnp.asarray(x)))
    port = create_model("unet_tpu", device="cpu", **kw)
    port.module.load_state_dict(from_jax_variables("unet_tpu", v), strict=True)
    return x, want, port


@pytest.mark.parametrize("head_mode,num_classes,h,w", [
    ("dts", 1, 64, 64),
    ("dts", 2, 64, 64),          # the (4, 4, nc) channel order is not pixel_shuffle's
    ("bilinear", 1, 64, 64),
    ("bilinear", 2, 32, 32),
    ("dts", 1, 66, 67),          # the stem floor-divides, logits resized back
    ("bilinear", 3, 35, 33),     # three classes, odd sizes
])
def test_unet_tpu_float_matches_jax(head_mode, num_classes, h, w):
    x, want, port = _pair(h, w, seed=num_classes, widths=NARROW, head_mode=head_mode,
                          num_classes=num_classes)
    with torch.no_grad():
        got = port.module(_nchw(x))["main"]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, num_classes, x.shape[1], x.shape[2])
    assert _rel(_nhwc(got), want) <= 1e-3
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("head_mode", ["dts", "bilinear"])
def test_unet_tpu_registry_default_matches_jax(head_mode):
    """create_model('unet_tpu') at the registry's widths (128, 256, 512, 512),
    64px: logits within 1e-3 rel L2 of JAX's."""
    x, want, port = _pair(64, 64, seed=5, head_mode=head_mode)
    assert [port.module.get_submodule(f"enc{i}").conv_op[0].out_channels for i in range(3)] == [
        128, 256, 512]
    assert port.module.bottleneck.conv_op[0].out_channels == 512
    with torch.no_grad():
        got = _nhwc(port.module(_nchw(x))["main"])
    assert _rel(got, want) <= 1e-3


def test_unet_tpu_bf16_model_runs():
    """bf16 compute: finite float32 logits near the float32 model's."""
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    outs = [create_model("unet_tpu", device="cpu", widths=NARROW, dtype=dt).module(x)["main"]
            for dt in (torch.float32, torch.bfloat16)]
    assert outs[1].dtype == torch.float32 and torch.isfinite(outs[1]).all()
    assert ((outs[1] - outs[0]).norm() / outs[0].norm()).item() <= 5e-2


def test_unet_tpu_rejects_unknown_head():
    with pytest.raises(ValueError, match="head_mode"):
        create_model("unet_tpu", device="cpu", widths=NARROW, head_mode="pixel_shuffle")


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2)])
def test_upsample2x_nearest_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_resize.upsample2x_nearest(jnp.asarray(x)))
    got = upsample2x_nearest(_nchw(x))
    assert got.is_contiguous(memory_format=CL)
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("size_in,size_out", [
    ((8, 8), (16, 16)), ((6, 9), (4, 3)), ((7, 5), (10, 13)), ((3, 6), (9, 4)), ((5, 5), (5, 5)),
])
def test_resize_nearest_matches_jax(size_in, size_out):
    x = np.random.default_rng(1).standard_normal((2, *size_in, 3)).astype(np.float32)
    want = np.asarray(jax_resize.resize_nearest(jnp.asarray(x), size_out))
    np.testing.assert_array_equal(_nhwc(resize_nearest(_nchw(x), size_out)), want)
