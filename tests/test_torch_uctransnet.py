"""uctransnet in the port against the JAX package (CPU, float32): the whole
model at 64px (registry config), its channel cross attention (with the
attention weights ``vis`` returns), a CTrans block and the CCA gate alone,
one train step with the same dropout masks on both sides, the converters,
and what it refuses (int8 serving, the pipelined bridge, a missing or other
image size).

The variables come from ``jax.eval_shape`` of JAX's init, every leaf drawn
from a numpy generator (``test_torch_conv_members.jax_member_variables``),
and enter the port through ``from_jax_variables``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_core_members as core
from test_torch_conv_members import (DROPOUT_SEED, jax_dropout_from, jax_member_variables,
                                     jax_module_variables, port_dropout_from)
from test_torch_core_members import _nchw, _nhwc
from unet_zoo_tpu.models import get_model_config as jax_get_model_config
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu_torch import create_model, get_model_config
from unet_zoo_tpu_torch.models.uctransnet import CCA, ChannelCrossAttention, CTransBlock
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.train.losses import multi_output_loss
from unet_zoo_tpu_torch.utils import convert
from unet_zoo_tpu_torch.utils.convert import from_jax_variables
from unet_zoo_tpu_torch.utils.serving import calibrate_int8, make_predictor

torch.set_num_threads(1)

SIZE = 64
CHANNELS = (16, 32, 64, 128)


def build(size, **kw):
    m, v = jax_member_variables("uctransnet", size, image_size=size, **kw)
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False))
    want = jax.tree_util.tree_map(np.asarray, apply(v, jnp.asarray(x)))
    return dict(name="uctransnet", kw={"image_size": size, **kw}, m=m, v=v, x=x, apply=apply,
                want=want)


@functools.lru_cache(maxsize=None)
def member():
    return build(SIZE)


def port_of(c, **kw):
    return core.port_model(c["name"], c["v"], **{**c["kw"], **kw})


def test_forward_matches_jax():
    """Eval logits within 1e-3 rel L2 of JAX's at 64px (4 tokens a scale)."""
    core.check_forward(member())


def test_vis_returns_jax_attention_weights():
    """``vis=True`` adds ``attn_weights``: per layer (4) a tuple of each
    scale's head-mean probabilities [B, C_i, KV], as JAX returns them;
    the logits are unchanged."""
    c = member()
    m, _ = jax_member_variables("uctransnet", SIZE, image_size=SIZE, vis=True)
    want = m.module.apply(c["v"], jnp.asarray(c["x"]), train=False)
    port = port_of(c, vis=True)
    with torch.no_grad():
        got = port.module(_nchw(c["x"]))
    assert sorted(got) == ["attn_weights", "main"]
    assert len(got["attn_weights"]) == len(want["attn_weights"]) == 4
    for layer_got, layer_want in zip(got["attn_weights"], want["attn_weights"]):
        assert len(layer_got) == len(layer_want) == 4
        for i, (g, w) in enumerate(zip(layer_got, layer_want)):
            assert tuple(g.shape) == np.asarray(w).shape == (2, CHANNELS[i], sum(CHANNELS))
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(got["main"], port_of(c).module(_nchw(c["x"]))["main"])


def test_attn_weights_pass_through_serving_and_the_loss():
    """``make_predictor`` serves the main logits of a ``vis`` model, and
    ``multi_output_loss`` weighs only 'main' (the weights are no logits)."""
    c = member()
    port = port_of(c, vis=True)
    x = _nchw(c["x"])
    logits = make_predictor(port, None, "logits", cast_bf16=False)(x)
    np.testing.assert_allclose(_nhwc(logits), c["want"]["main"], rtol=0,
                               atol=1e-3 * np.abs(c["want"]["main"]).max())
    with torch.no_grad():
        out = port.module(x)
    mask = (torch.rand(2, 1, SIZE, SIZE, generator=torch.Generator().manual_seed(0)) > 0.5)
    keys = []
    loss = multi_output_loss(out, mask.float(), lambda k: keys.append(k) or 1.0)
    assert keys == ["main"]
    assert torch.equal(loss, multi_output_loss({"main": out["main"]}, mask.float(),
                                               lambda k: 1.0))


def test_converters_invert_jax_converters():
    """from_jax_variables inverts JAX's ``convert_uctransnet`` (the original
    zoo's per-head Linear keys) exactly, both ways."""
    port = create_model("uctransnet", device="cpu", seed=3, image_size=SIZE)
    sd = port.module.state_dict()
    assert "mtc.encoder.layer.3.channel_attn.query4.3.weight" in sd
    v = convert_state_dict("uctransnet", dict(sd))
    back = from_jax_variables("uctransnet", v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    again = convert_state_dict("uctransnet", back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, v)


def test_train_step_matches_jax():
    """One step from the same variables and batch, the embeddings' and FFNs'
    dropout (0.1; 36 draws: 4 embeddings, 2 in each of 4 FFNs in 4 layers)
    dropping the same units on both sides (``check_train_step``, conditioned:
    train-mode BatchNorm down to 4 x 4 maps of a batch of 2 puts a running
    mean of the port's float32 step 2.2e-5 from JAX's, beyond the direct
    check's 1e-5)."""
    with jax_dropout_from(DROPOUT_SEED) as rates, port_dropout_from(DROPOUT_SEED):
        core.check_train_step(member(), conditioned=True)
    assert rates == [0.1] * 36


# --- modules ---------------------------------------------------------------------


def _attention_state(sd, prefix, ca):
    for name in [f"query{i}" for i in range(1, 5)] + ["key", "value"]:
        for h, w in enumerate(np.asarray(ca[name])):
            sd[f"{prefix}{name}.{h}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
    for i in range(1, 5):
        convert._dense(sd, f"{prefix}out{i}", ca[f"out{i}"])


def _tokens(rng, n):
    return [rng.standard_normal((2, n, c)).astype(np.float32) for c in CHANNELS]


def test_channel_cross_attention_matches_jax():
    """The cross attention alone over 16 tokens a scale, with ``vis``: the
    scores over sqrt(KV_size) (240), the per-head instance norm over each
    (C_i, KV) map, softmax over KV, the head mean, ``out{i}``; outputs and
    head-mean probabilities."""
    from unet_zoo_tpu.models.uctransnet import ChannelCrossAttention as JaxCCA

    rng = np.random.default_rng(1)
    embs = _tokens(rng, 16)
    emb_all = np.concatenate(embs, axis=2)
    j = JaxCCA(CHANNELS, 4, vis=True)
    v = jax_module_variables(j, [jnp.asarray(e) for e in embs], jnp.asarray(emb_all))
    outs, weights = j.apply(v, [jnp.asarray(e) for e in embs], jnp.asarray(emb_all))
    port = ChannelCrossAttention(CHANNELS, 4)
    sd = {}
    _attention_state(sd, "", v["params"])
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, got_w = port([torch.from_numpy(e) for e in embs], torch.from_numpy(emb_all),
                          vis=True)
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    for g, w in zip(got_w, weights):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_ctrans_block_matches_jax(train):
    """A CTrans block: pre-LN (eps 1e-6) attention with a residual, the
    per-scale FFN (exact GELU) with a residual; in training with the same
    dropout masks (8 draws)."""
    from unet_zoo_tpu.models.uctransnet import CTransBlock as JaxBlock

    rng = np.random.default_rng(2)
    embs = _tokens(rng, 9)
    j = JaxBlock(CHANNELS, 4, 4)
    v = jax_module_variables(j, [jnp.asarray(e) for e in embs])
    with jax_dropout_from(DROPOUT_SEED) as rates:
        want, _ = j.apply(v, [jnp.asarray(e) for e in embs], train,
                          rngs={"dropout": jax.random.PRNGKey(0)})
    assert rates == ([0.1] * 8 if train else [])
    port = CTransBlock(CHANNELS, 4, 4).train(train)
    p, sd = v["params"], {}
    for i in range(1, 5):
        convert._ln(sd, f"attn_norm{i}", p[f"attn_norm{i}"])
        convert._ln(sd, f"ffn_norm{i}", p[f"ffn_norm{i}"])
        convert._dense(sd, f"ffn{i}.fc1", p[f"ffn{i}_fc1"])
        convert._dense(sd, f"ffn{i}.fc2", p[f"ffn{i}_fc2"])
    convert._ln(sd, "attn_norm", p["attn_norm"])
    _attention_state(sd, "channel_attn.", p["channel_attn"])
    port.load_state_dict(sd, strict=True)
    got, _ = port([torch.from_numpy(e) for e in embs],
                  generator=torch.Generator().manual_seed(DROPOUT_SEED))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_cca_matches_jax():
    """The CCA gate: sigmoid of the mean of both pooled projections scales
    the skip's channels, then ReLU."""
    from unet_zoo_tpu.models.uctransnet import CCA as JaxCCA

    rng = np.random.default_rng(3)
    g = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    j = JaxCCA()
    v = jax_module_variables(j, jnp.asarray(g), jnp.asarray(x))
    want = np.asarray(j.apply(v, jnp.asarray(g), jnp.asarray(x)))
    port = CCA(32, 32)
    sd = {}
    convert._dense(sd, "mlp_x.1", v["params"]["mlp_x"])
    convert._dense(sd, "mlp_g.1", v["params"]["mlp_g"])
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_nchw(g), _nchw(x), torch.float32)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)


# --- the registry and what it refuses -----------------------------------------------


def test_registry_config_matches_jax():
    """``get_model_config('uctransnet')`` equals JAX's; a config handed to
    ``create_model`` sets the layers, heads and widths (2 layers, 2 heads)."""
    assert get_model_config("uctransnet") == jax_get_model_config("uctransnet")
    cfg = get_model_config("uctransnet")
    cfg["transformer"]["num_layers"], cfg["transformer"]["num_heads"] = 2, 2
    port = create_model("uctransnet", device="cpu", image_size=SIZE, config=cfg)
    assert len(port.module.mtc.encoder.layer) == 2
    assert len(port.module.mtc.encoder.layer[0].channel_attn.key) == 2


def test_requires_image_size():
    """Without ``image_size`` the registry raises, as JAX's does; a model
    built for one size refuses another (its position tables)."""
    from unet_zoo_tpu.models import create_model as jax_create_model

    for create in (jax_create_model, lambda n: create_model(n, device="cpu")):
        with pytest.raises(ValueError, match="requires 'image_size'"):
            create("uctransnet")
    port = create_model("uctransnet", device="cpu", image_size=SIZE)
    with pytest.raises(ValueError, match="built for 4 tokens"):
        port.module(torch.zeros(1, 3, 128, 128))


def test_bridge_pipeline_raises_naming_the_roadmap_item():
    """The pipelined channel-transformer bridge is not ported: asking for it
    raises, naming ROADMAP Queue 1 item 10."""
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item 10"):
        create_model("uctransnet", device="cpu", image_size=SIZE, bridge_pipeline=(None, 2, None))


def test_int8_calibration_raises_as_jax():
    """No conv of uctransnet is int8-gated (JAX's are plain convs), so
    ``calibrate_int8`` raises on both sides."""
    from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8

    c = member()
    with pytest.raises(ValueError, match="no quantizable convs"):
        jax_calibrate_int8(c["m"], c["v"], [jnp.asarray(c["x"][:1])])
    with pytest.raises(ValueError, match="no quantizable convs"):
        calibrate_int8(port_of(c), [_nchw(c["x"][:1])])


def test_train_step_draws_dropout_from_the_steps_generator():
    """Two steps from one seed agree bit for bit, another seed moves the loss."""
    images = torch.randint(0, 256, (2, 3, 32, 32), generator=torch.Generator().manual_seed(0),
                           dtype=torch.uint8)
    masks = (images[:, :1] > 127).to(torch.uint8)
    losses = []
    for seed in (1, 1, 2):
        model = create_model("uctransnet", device="cpu", seed=0, image_size=32)
        step = make_train_step(model, generator=torch.Generator().manual_seed(seed))
        losses.append(step(create_train_state(model), images, masks)["loss"].item())
    assert losses[0] == losses[1] != losses[2]
