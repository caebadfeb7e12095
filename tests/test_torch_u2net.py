"""u2net and u2netp in the port against the JAX package (CPU, float32), at
44px, where ceil-mode pooling pads (44 -> 22 -> 11 -> 6 -> 3 -> 2) and the
upsampling to each feature's size is no power-of-two ratio: eval logits of
all seven output keys and one ``make_train_step``, as
``tests/test_torch_core_members.py`` holds its members (its helpers are
shared); and ``make_predictor(quant=...)`` refusing their dilated gated convs.
"""

import functools

import pytest
import torch

from test_torch_core_members import build_member, check_forward, check_train_step
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.utils.serving import calibrate_int8, make_predictor

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


@pytest.mark.parametrize("name", sorted(MEMBERS))
def test_int8_serving_refuses_dilated_convs(name):
    """JAX gates every REBNCONV conv and serves the dilated ones int8; the
    port's int8 conv takes 3x3 convs with padding 1, so the predictor raises,
    naming the first such conv, rather than serve part of the model in float."""
    port = create_model(name, device="cpu")
    stats = calibrate_int8(port, [torch.randn(1, 3, 44, 44)])
    assert len(stats) == 112        # RSU-L has 2L convs, RSU-4F 8: 60 up, 52 down
    with pytest.raises(ValueError, match=r"stage1\.rebnconv7\.conv_s1: the int8 conv takes"):
        make_predictor(port, None, "logits", quant=stats)
