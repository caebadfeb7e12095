"""The whole slice: the port's ``unet`` and ``make_predictor`` against the
JAX package at full width (32px, B=2, float32 compute), with the JAX
weights carried over by ``from_jax_variables``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import make_predictor as jax_make_predictor
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.utils.convert import from_jax_variables
from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference, make_predictor

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def jax_unet():
    """JAX unet variables with BN statistics and affine moved off identity."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    m = jax_create_model("unet")
    v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def perturb(params, stats):
        if "mean" in stats:
            stats["mean"] = jnp.asarray(rng.standard_normal(stats["mean"].shape) * 0.1,
                                        jnp.float32)
            stats["var"] = jnp.asarray(rng.random(stats["var"].shape) + 0.5, jnp.float32)
            params["scale"] = jnp.asarray(rng.random(params["scale"].shape) + 0.5,
                                          jnp.float32)
            return
        for k in stats:
            perturb(params[k], stats[k])

    perturb(v["params"], v["batch_stats"])
    v = jax.tree_util.tree_map(np.asarray, v)
    return m, v, x


def _port(v, use_kernels):
    m = create_model("unet", device="cpu", use_kernels=use_kernels)
    m.module.load_state_dict(from_jax_variables("unet", v), strict=True)
    return m


@pytest.mark.parametrize("use_kernels", [True, False])
def test_eval_logits_match_jax(jax_unet, use_kernels):
    """Kernel path (its plain version on the CPU) and module path against the
    JAX forward with the Pallas decoder (interpret mode) and without."""
    jm, v, x = jax_unet
    ref = jm.module.clone(use_pallas=use_kernels).apply(v, jnp.asarray(x), train=False)["main"]
    m = _port(v, use_kernels)
    with torch.no_grad():
        got = m.module(_nchw(x))["main"]
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_state_dict_keys_round_trip(jax_unet):
    _, v, _ = jax_unet
    sd = _port(v, None).module.state_dict()
    back = convert_state_dict("unet", {k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)
                         for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cast_params_for_inference(jax_unet):
    _, v, _ = jax_unet
    net = cast_params_for_inference(_port(v, None).module)
    assert net.out.conv.weight.dtype == torch.bfloat16
    bn = net.up_convolution_1.conv.conv_op[1]
    assert bn.weight.dtype == torch.bfloat16                 # BN affine is a param
    assert bn.running_mean.dtype == torch.float32            # statistics stay f32


@pytest.mark.parametrize("tta", [False, True])
def test_predictor_matches_jax(jax_unet, tta):
    """bf16-rounded weights, f32 compute: the port's kernel path against the
    JAX predictor. Masks must agree wherever the JAX probability is more
    than 1e-3 from the threshold."""
    jm, v, x = jax_unet
    m = _port(v, True)
    probs_ref = np.asarray(jax_make_predictor(jm, v, "probs", tta=tta)(jnp.asarray(x)))
    probs = _nhwc(make_predictor(m, None, "probs", tta=tta)(_nchw(x)))
    np.testing.assert_allclose(probs, probs_ref, rtol=2e-3, atol=2e-3)
    mask = _nhwc(make_predictor(m, None, "mask", tta=tta)(_nchw(x)))
    assert set(np.unique(mask)) <= {0, 1}
    far = np.abs(probs_ref - 0.5) > 1e-3
    np.testing.assert_array_equal(mask[far], (probs_ref > 0.5)[far].astype(np.float32))
    if tta:
        with pytest.raises(ValueError, match="tta"):
            make_predictor(m, None, "logits", tta=True)
    else:
        ref = np.asarray(jax_make_predictor(jm, v, "logits")(jnp.asarray(x)))
        got = _nhwc(make_predictor(m, None, "logits")(_nchw(x)))
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_odd_size_routes_module_path(jax_unet):
    """36px: stages whose skip is not exactly 2x take the module path with
    pad_to_match; the rest run the kernel path."""
    jm, v, _ = jax_unet
    x = np.random.default_rng(1).standard_normal((1, 36, 36, 3)).astype(np.float32)
    ref = jm.module.apply(v, jnp.asarray(x), train=False)["main"]
    m = _port(v, True)
    with torch.no_grad():
        got = m.module(_nchw(x))["main"]
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=2e-3, atol=2e-3)
