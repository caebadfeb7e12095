"""u2net and u2netp in the port against the JAX package (CPU, float32), at
44px, where ceil-mode pooling pads (44 -> 22 -> 11 -> 6 -> 3 -> 2) and the
upsampling to each feature's size is no power-of-two ratio: eval logits of
all seven output keys and one ``make_train_step``, as
``tests/test_torch_core_members.py`` holds its members (its helpers are
shared); and int8 serving, whose 112 gated convs include the dilation-2, -4
and -8 ones of every RSU: calibration, every gated conv exactly, the whole
model's distance from float against JAX's own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core_members import (_nchw, _nhwc, build_member, check_forward,
                                     check_int8_strays_as_far_as_jax, check_train_step,
                                     port_model)
from unet_zoo_tpu.nn.blocks import _QuantConv
from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8
from unet_zoo_tpu_torch.nn import blocks
from unet_zoo_tpu_torch.utils.convert import quant_from_jax
from unet_zoo_tpu_torch.utils.serving import calibrate_int8

torch.set_num_threads(1)

MEMBERS = {"u2net": ("u2net", 44, {}), "u2netp": ("u2netp", 44, {})}


@functools.lru_cache(maxsize=None)
def member(key):
    return build_member(*MEMBERS[key])


@pytest.mark.parametrize("key", sorted(MEMBERS))
def test_forward_matches_jax(key):
    c = member(key)
    assert sorted(c["want"]) == ["main"] + [f"side{i}" for i in range(1, 7)]
    check_forward(c)


@pytest.mark.parametrize("key", sorted(MEMBERS))
def test_train_step_matches_jax(key):
    """Every key at the unit U2NET weight; the gradients against a float64
    copy on the float32 step's branches (``check_train_step``): the RSU
    pyramids reach 1-3 px, where train-mode BatchNorm normalises 2-18 values
    a channel."""
    c = member(key)
    assert all(c["m"].loss_weight(k) == 1.0 for k in c["want"])
    check_train_step(c, conditioned=True)


@functools.lru_cache(maxsize=None)
def calibrated(key):
    """Two seeded 44px batches and JAX's ``quant`` collection from them."""
    c = member(key)
    rng = np.random.default_rng(44)
    xs = [rng.standard_normal((1, 44, 44, 3)).astype(np.float32) * s for s in (1.0, 1.5)]
    vq = jax_calibrate_int8(c["m"], c["v"], [jnp.asarray(x) for x in xs])
    return xs, jax.tree_util.tree_map(np.asarray, vq["quant"])


@pytest.mark.parametrize("key", sorted(MEMBERS))
def test_int8_calibration_matches_jax(key):
    """calibrate_int8 records JAX's 112 statistics (RSU-L has 2L convs,
    RSU-4F 8: 60 up, 52 down) with the same maxima to float rounding, and
    quant_from_jax names the same convs."""
    c = member(key)
    xs, quant = calibrated(key)
    stats = calibrate_int8(port_model(c["name"], c["v"]), [_nchw(x) for x in xs])
    want = quant_from_jax(c["name"], quant)
    assert len(stats) == len(want) == len(jax.tree_util.tree_leaves(quant)) == 112
    assert sorted(stats) == sorted(want)
    for k in want:
        np.testing.assert_allclose(stats[k].item(), want[k].item(), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("key", ["u2netp"])
def test_int8_every_gated_conv_matches_jax(key, monkeypatch):
    """Served int8 on JAX's statistics, every one of u2netp's 112 gated convs
    (dilations 1, 2, 4 and 8, on maps down to 2 x 2 where the dilated taps
    fall outside) equals JAX's ``_QuantConv`` with the conv's padding and
    ``kernel_dilation``, op by op, on the same input, weights and absmax, bit
    for bit; the int8 path ran (logits away from float). u2net has the same
    convs at wider channels; JAX's op-by-op convs at its widths take 40 s,
    so it is held whole (below) and on the card, launch by launch."""
    c = member(key)
    xs, quant = calibrated(key)
    stats = quant_from_jax(c["name"], quant)
    port = port_model(c["name"], c["v"])
    calls, gated = [], blocks.gated_conv

    def recording(x, conv_m, dtype, use_kernels=None):
        y = gated(x, conv_m, dtype, use_kernels)
        if getattr(conv_m, "int8", None) is not None:
            calls.append((x, conv_m, y))
        return y

    monkeypatch.setattr(blocks, "gated_conv", recording)
    blocks.attach_int8(port.module, stats)
    with torch.no_grad():
        got = _nhwc(port.module(_nchw(xs[0]))["main"])
    monkeypatch.setattr(blocks, "gated_conv", gated)
    assert len(calls) == 112
    assert {conv_m.dilation[0] for _, conv_m, _ in calls} == {1, 2, 4, 8}
    served = {m: n for n, m in port.module.named_modules()}
    for x, conv_m, y in calls:
        params = {"kernel": jnp.asarray(conv_m.weight.detach().numpy().transpose(2, 3, 1, 0)),
                  "bias": jnp.asarray(conv_m.bias.detach().numpy())}
        want = _QuantConv(conv_m.out_channels, padding=conv_m.padding[0],
                          kernel_dilation=conv_m.dilation[0]).apply(
            {"params": params}, jnp.asarray(_nhwc(x)), jnp.float32(stats[served[conv_m]]))
        np.testing.assert_array_equal(_nhwc(y), np.asarray(want), err_msg=served[conv_m])
    assert _rel_main(got, c) > 1e-3


def _rel_main(got, c):
    want = np.asarray(c["want"]["main"], np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("key", sorted(MEMBERS))
def test_int8_strays_from_float_as_far_as_jax(key):
    """The whole int8 model (``make_predictor(quant=...)``, float32 weights)
    lies no further from float than 1.25 times JAX's int8 on the same
    variables, statistics and input."""
    xs, quant = calibrated(key)
    c = member(key)
    check_int8_strays_as_far_as_jax(c, quant_from_jax(c["name"], quant), quant, xs[1],
                                    apply=lambda v_, x_: c["apply"](v_, x_)["main"])
