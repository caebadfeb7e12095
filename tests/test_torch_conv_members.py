"""transatt_unet, unet_transformer, multiresunet and vnet in the port against
the JAX package (CPU, float32), with the blocks they add (``Down``,
``UpBilinear``, the extended ``ConvNormAct``, ``sincos_posenc_2d``).

Each model gets the same seeded random variables on both sides (JAX's tree
from ``jax.eval_shape``, leaves drawn by ``test_torch_core_members._draw``),
carried into the port by ``from_jax_variables``, which inverts the JAX
package's converters (the original zoo's names). Held against JAX: eval
logits (rel L2 1e-3), one ``make_train_step`` (``check_train_step``: loss,
Dice, every output key at its spec's weight, gradients and running
statistics), with vnet's and transatt_unet's dropout masks the same on both
sides (:func:`jax_dropout_from`), and int8 serving of transatt_unet and
unet_transformer conv by conv; multiresunet's int8 serving is refused.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_core_members as core
from test_torch_core_members import _draw, _nchw, _nhwc, _rel
from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.models import list_models as jax_list_models
from unet_zoo_tpu.nn.blocks import _QuantConv
from unet_zoo_tpu.nn.posenc import _sincos_2d
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.models import _REGISTRY
from unet_zoo_tpu_torch.nn import ConvNormAct, Down, UpBilinear, blocks
from unet_zoo_tpu_torch.nn.posenc import sincos_posenc_2d
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.utils.convert import from_jax_variables, quant_from_jax
from unet_zoo_tpu_torch.utils.serving import calibrate_int8, make_predictor

torch.set_num_threads(1)

NEW_NAMES = ("multiresunet", "raunet", "transatt_unet", "unet_transformer", "vnet")
UNSERVED = ("da_transformer", "egeunet", "uctransnet")
# PAM's gamma, zero at init, drawn off zero on both sides so that the
# spatial attention enters the logits
PAM_GAMMA = 0.5


def jax_member_variables(name, size, in_channels=3, seed=0, **kw):
    """The JAX model and its {'params', 'batch_stats'} (empty for vnet) drawn
    by ``_draw`` over the init's shapes; transatt_unet's gamma set to
    PAM_GAMMA."""
    m = jax_create_model(name, in_channels=in_channels, **kw)
    shapes = jax.eval_shape(lambda: m.module.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, size, size, in_channels))))
    rng = np.random.default_rng(seed)
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    drawn = [_draw(rng, [getattr(k, "key", k) for k in path], leaf.shape).astype(np.float32)
             for path, leaf in leaves]
    v = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), drawn)
    v = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    if name == "transatt_unet":
        v["params"]["pam"]["gamma"] = np.full((1,), PAM_GAMMA, np.float32)
    return m, v


def build(name, size, kw):
    """JAX model, variables, a seeded batch of 2 and its jitted eval outputs,
    as ``test_torch_core_members.build_member`` (any input channel count)."""
    cin = kw.get("in_channels", 3)
    m, v = jax_member_variables(name, size, **kw)
    x = np.random.default_rng(size).standard_normal((2, size, size, cin)).astype(np.float32)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False))
    want = {k: np.asarray(o) for k, o in apply(v, jnp.asarray(x)).items()}
    return dict(name=name, kw=kw, m=m, v=v, x=x, apply=apply, want=want)


# (registry name, image size, kwargs): unet_transformer at a small attn_res
# (16 -> 8 and 32 -> 8: shrinking) and at the default (64, 64), where every
# pooled map is enlarged; vnet with 1 (tiled) and 3 (in_adapt) input channels
# and with PReLUs
MEMBERS = {
    "transatt_unet": ("transatt_unet", 64, {}),
    "unet_transformer_small": ("unet_transformer", 64, {"common_attn_res_for_QK_V": (8, 8)}),
    "unet_transformer": ("unet_transformer", 64, {}),
    "multiresunet": ("multiresunet", 64, {}),
    "vnet": ("vnet", 64, {}),
    "vnet_1ch": ("vnet", 32, {"in_channels": 1}),
    "vnet_prelu": ("vnet", 32, {"elu": False}),
}


@functools.lru_cache(maxsize=None)
def member(key):
    return build(*MEMBERS[key])


def port_of(c):
    return core.port_model(c["name"], c["v"], **c["kw"])


@pytest.mark.parametrize("key", sorted(MEMBERS))
def test_forward_matches_jax(key):
    """Eval logits within 1e-3 rel L2 of JAX's, at the input's size."""
    c = member(key)
    with torch.no_grad():
        got = port_of(c).module(_nchw(c["x"]))
    assert sorted(got) == ["main"]
    want = c["want"]["main"]
    assert want.shape == (2, c["x"].shape[1], c["x"].shape[2], 1)
    assert _nhwc(got["main"]).shape == want.shape
    assert _rel(_nhwc(got["main"]), want) <= 1e-3, _rel(_nhwc(got["main"]), want)


def test_transatt_unet_spatial_attention_enters_the_logits():
    """With gamma at zero (its init) the logits move: PAM is exercised."""
    c = member("transatt_unet")
    port = port_of(c)
    with torch.no_grad():
        port.module.pam.gamma.zero_()
        got = _nhwc(port.module(_nchw(c["x"]))["main"])
    assert _rel(got, c["want"]["main"]) > 1e-2


@pytest.mark.parametrize("name,kw", [("transatt_unet", {}), ("unet_transformer", {}),
                                     ("multiresunet", {}), ("vnet", {"in_channels": 1})])
def test_converters_invert_jax_converters(name, kw):
    """from_jax_variables inverts the JAX package's converter (the original
    zoo's names) exactly, both ways. vnet's ContBatchNorm keeps no running
    statistics on either side; JAX's converter has no in_adapt conv nor
    PReLU, so vnet's PReLUs and 3-channel stem are held by the forwards
    above and its 1-channel stem here."""
    port = create_model(name, device="cpu", seed=3, **kw)
    sd = port.module.state_dict()
    v = convert_state_dict(name, dict(sd))
    back = from_jax_variables(name, v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    again = convert_state_dict(name, back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, v)


# --- dropout: the same masks on both sides ---------------------------------------


DROPOUT_SEED = 11


@contextlib.contextmanager
def jax_dropout_from(seed):
    """Within, Flax's ``nn.Dropout`` keeps by uniforms drawn from a torch
    generator seeded ``seed``, in call order, at the shapes the port draws
    (NCHW, a channel dropout at [B, C, 1, 1]), so that it drops what the
    port's forward does with ``generator=torch.Generator().manual_seed(seed)``.
    The rates are the registry's (0.5 channel, 0.1 attention)."""
    import flax.linen as fnn

    g = torch.Generator().manual_seed(seed)
    rates = []

    def call(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        rates.append(self.rate)
        keep = 1.0 - self.rate
        if inputs.ndim == 4:
            b, h, w, ch = inputs.shape
            shape = (b, ch, 1, 1) if tuple(self.broadcast_dims) == (1, 2) else (b, ch, h, w)
            u = torch.rand(shape, generator=g).numpy().transpose(0, 2, 3, 1)
        else:
            u = torch.rand(inputs.shape, generator=g).numpy()
        return jnp.where(jnp.asarray(u < keep), inputs / keep, jnp.zeros_like(inputs))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", call)
        yield rates


@contextlib.contextmanager
def port_dropout_from(seed):
    """Within, ``make_train_step`` (as the shared check calls it) hands the
    forward a generator seeded ``seed``, fresh for every step it builds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(core, "make_train_step", lambda model: make_train_step(
            model, generator=torch.Generator().manual_seed(seed)))
        yield


# dropout calls a train forward makes: vnet's channel dropouts (down128,
# down256, up256 and up128 inputs, four skips), transatt_unet's attention
DROPOUTS = {"vnet": [0.5] * 8, "transatt_unet": [0.1]}


@pytest.mark.parametrize("key,conditioned", [("transatt_unet", True),
                                             ("unet_transformer_small", True),
                                             ("multiresunet", True), ("vnet", False)])
def test_train_step_matches_jax(key, conditioned):
    """One step from the same variables and batch (``check_train_step``:
    loss and Dice at 1e-5, each key at the JAX spec's weight, gradients and
    running statistics; the conditioned models in two parts against a
    float64 copy of the port). vnet and transatt_unet drop the same units on
    both sides. multiresunet's ``batch_norm1`` is one BN applied twice: its
    running statistics moved twice, as JAX's ``shared_bn``."""
    c = member(key)
    name = c["name"]
    with jax_dropout_from(DROPOUT_SEED) as rates, port_dropout_from(DROPOUT_SEED):
        core.check_train_step(c, conditioned)
    assert rates == DROPOUTS.get(name, [])
    if name == "multiresunet":
        port = port_of(c)
        images = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        masks = np.zeros((2, 64, 64, 1), np.uint8)
        core._step_grads(port, images, masks)
        for i in range(1, 10):
            bn = getattr(port.module, f"multiresblock{i}").batch_norm1
            assert bn.num_batches_tracked.item() == 2 and bn.weight is None


def test_dropout_draws_from_the_steps_generator():
    """vnet's channel dropout in training draws from the generator the step
    is given: two steps from one seed agree bit for bit, another seed moves
    the loss; in eval nothing is drawn."""
    images = torch.randint(0, 256, (2, 3, 32, 32), generator=torch.Generator().manual_seed(0),
                           dtype=torch.uint8)
    masks = (images[:, :1] > 127).to(torch.uint8)
    losses = []
    for seed in (1, 1, 2):
        model = create_model("vnet", device="cpu", seed=0)
        state = create_train_state(model)
        step = make_train_step(model, generator=torch.Generator().manual_seed(seed))
        losses.append(step(state, images, masks)["loss"].item())
    assert losses[0] == losses[1] != losses[2]
    model = create_model("vnet", device="cpu", seed=0)
    with torch.no_grad():
        a = model.module(images.float(), torch.Generator().manual_seed(1))["main"]
        b = model.module(images.float(), torch.Generator().manual_seed(2))["main"]
    assert torch.equal(a, b)


# --- blocks ---------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_down_and_up_bilinear_match_jax(train):
    """``Down`` (max pool, DoubleConvMid) on a 13 x 10 map, and
    ``UpBilinear`` (bilinear x2 with align_corners, pad to an odd skip,
    concat[skip, x], mid = in // 2), eval and train mode; after a train
    forward the running statistics match JAX's."""
    from unet_zoo_tpu.nn import Down as JaxDown
    from unet_zoo_tpu.nn import UpBilinear as JaxUp

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, 10, 6)).astype(np.float32)
    jd = JaxDown(8)
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    vd = jax.tree_util.tree_map(lambda s: _draw(rng, ["kernel"], s.shape).astype(np.float32)
                                if len(s.shape) == 4 else (rng.random(s.shape) + 0.5
                                                          ).astype(np.float32), shapes)
    port_d = Down(6, 8).train(train)
    port_d.load_state_dict(from_mid(vd, "maxpool_conv.1"), strict=True)
    want = jd.apply(vd, jnp.asarray(x), train, mutable=["batch_stats"] if train else False)
    got = port_d(_nchw(x))
    _check_block(got, want, port_d, "maxpool_conv.1", train)

    y = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    skip = rng.standard_normal((2, 11, 9, 8)).astype(np.float32)
    ju = JaxUp(6, 8)
    shapes = jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0), jnp.asarray(y),
                                            jnp.asarray(skip)))
    vu = jax.tree_util.tree_map(lambda s: _draw(rng, ["kernel"], s.shape).astype(np.float32)
                                if len(s.shape) == 4 else (rng.random(s.shape) + 0.5
                                                          ).astype(np.float32), shapes)
    port_u = UpBilinear(16, 6, 8).train(train)
    port_u.load_state_dict(from_mid(vu, "conv"), strict=True)
    want = ju.apply(vu, jnp.asarray(y), jnp.asarray(skip), train,
                    mutable=["batch_stats"] if train else False)
    got = port_u(_nchw(y), _nchw(skip))
    _check_block(got, want, port_u, "conv", train)


def from_mid(v, prefix):
    """A JAX block holding one DoubleConvMid -> the port block's state_dict."""
    sd = {}
    core_p = next(iter(v["params"].values()))
    core_s = next(iter(v["batch_stats"].values()))
    from unet_zoo_tpu_torch.utils import convert

    convert._double_conv(sd, f"{prefix}.double_conv", core_p, core_s)
    return sd


def _check_block(got, want, port, prefix, train):
    """The block's output within 1e-5 of JAX's; after a train forward, its
    two BNs' running statistics too."""
    out, stats = want if train else (want, None)
    np.testing.assert_allclose(_nhwc(got), np.asarray(out), rtol=1e-5, atol=1e-5)
    if train:
        sd = port.state_dict()
        st = next(iter(stats["batch_stats"].values()))
        for i, idx in enumerate((1, 4)):
            bn = st[f"ConvNormAct_{i}"]["BatchNorm_0"]
            for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(sd[f"{prefix}.double_conv.{idx}.{ours}"].numpy(),
                                           np.asarray(bn[theirs]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kernel_size,act,affine", [(1, None, False), (3, "relu", False),
                                                    (3, "relu", True), (3, None, True)])
def test_conv_norm_act_matches_jax(kernel_size, act, affine, train):
    """The extended ConvNormAct against JAX's on a 9 x 7 map: a 1x1 or 3x3
    conv, BN with or without affine (no weight or bias in the state_dict
    without), ReLU or none; eval and train mode, running statistics after."""
    from unet_zoo_tpu.nn import ConvNormAct as JaxCNA

    rng = np.random.default_rng(kernel_size + 2 * affine)
    x = rng.standard_normal((2, 9, 7, 5)).astype(np.float32)
    j = JaxCNA(6, kernel_size=kernel_size, padding=kernel_size // 2,
               act=None if act is None else jax.nn.relu, bn_affine=affine)
    shapes = jax.eval_shape(lambda: j.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [_draw(rng, [getattr(k, "key", k) for k in path], s.shape).astype(np.float32)
         for path, s in jax.tree_util.tree_leaves_with_path(shapes)])
    port = ConvNormAct(5, 6, kernel_size=kernel_size, act=act, bn_affine=affine).train(train)
    sd = {"conv.weight": torch.from_numpy(np.asarray(v["params"]["Conv_0"]["kernel"])
                                          .transpose(3, 2, 0, 1).copy()),
          "conv.bias": torch.from_numpy(np.asarray(v["params"]["Conv_0"]["bias"])),
          "bn.running_mean": torch.from_numpy(np.asarray(v["batch_stats"]["BatchNorm_0"]["mean"])),
          "bn.running_var": torch.from_numpy(np.asarray(v["batch_stats"]["BatchNorm_0"]["var"])),
          "bn.num_batches_tracked": torch.tensor(0)}
    if affine:
        sd["bn.weight"] = torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["scale"]))
        sd["bn.bias"] = torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"]["bias"]))
    assert sorted(port.state_dict()) == sorted(sd)
    port.load_state_dict(sd, strict=True)
    out = j.apply(v, jnp.asarray(x), train, mutable=["batch_stats"] if train else False)
    want, stats = out if train else (out, None)
    got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    if act is not None:
        assert (got >= 0).all()
    if train:
        bn = stats["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(bn["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(bn["var"]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w,c", [(8, 8, 512), (16, 16, 256), (5, 7, 3), (4, 6, 65),
                                   (64, 64, 64)])
def test_sincos_posenc_matches_jax(h, w, c):
    """The port's table equals JAX's ``_sincos_2d`` (channels first), in
    float32 exactly and cast to bfloat16 as JAX casts it."""
    got = sincos_posenc_2d(torch.zeros(2, c, h, w))
    np.testing.assert_array_equal(got[0].numpy().transpose(1, 2, 0), _sincos_2d(h, w, c))
    got = sincos_posenc_2d(torch.zeros(1, c, h, w, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(_sincos_2d(h, w, c)).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got[0].float().numpy().transpose(1, 2, 0), want)


def test_transatt_unet_refuses_a_bottleneck_beyond_its_tables():
    """The position tables hold 32 rows and columns (512px images): a
    larger bottleneck raises with a message, as JAX's forward fails."""
    m = create_model("transatt_unet", device="cpu")
    m.module.pos(torch.zeros(1, 512, 32, 32))
    with pytest.raises(ValueError, match="position tables hold 32"):
        m.module.pos(torch.zeros(1, 512, 33, 20))


# --- the registry -------------------------------------------------------------------


def test_registry_serves_all_but_the_hybrids():
    """25 names: JAX's list without uctransnet, da_transformer, egeunet."""
    assert list_models() == sorted(set(jax_list_models()) - set(UNSERVED))
    assert len(list_models()) == 25


@pytest.mark.parametrize("name", NEW_NAMES)
def test_registry_spec_fields_match_jax(name):
    """Each ModelSpec field the port keeps equals JAX's; the pretrained
    hook is set where JAX's is (raunet)."""
    spec, jax_spec = _REGISTRY[name], JAX_REGISTRY[name]
    for field in ("requires_image_size", "default_image_size", "loss_weights",
                  "default_aux_weight", "config_fn", "pretrained_by_default"):
        assert getattr(spec, field) == getattr(jax_spec, field), field
    assert (spec.pretrained_loader is None) == (jax_spec.pretrained_loader is None)
    for key in ("main", "side1"):
        assert spec.loss_weight(key) == jax_spec.loss_weight(key)


def test_convergence_config4_names_build_and_forward():
    """Every model of configs/convergence_config4.yaml builds through the
    port's Config and the train CLI's parameter merge (bf16, as the YAML
    asks) and forwards a 32px batch to finite logits of its size."""
    import yaml

    from unet_zoo_tpu_torch.cli.train import merged_model_params
    from unet_zoo_tpu_torch.config import Config

    with open("configs/convergence_config4.yaml") as f:
        overall = yaml.safe_load(f)
    config = Config(overall, create_dirs=False, device="cpu")
    names = overall["models"]["names"]
    assert set(names) <= set(list_models())
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    for name in names:
        params = merged_model_params(overall, name, config.NUM_CLASSES, config.IMAGE_SIZE,
                                     config.COMPUTE_DTYPE)
        model = create_model(name, device="cpu", seed=config.SEED, **params)
        with torch.no_grad():
            out = model.module(x)["main"]
        assert out.shape == (2, 1, 32, 32) and out.dtype == torch.bfloat16, name
        assert torch.isfinite(out.float()).all(), name


# --- int8 ----------------------------------------------------------------------------


INT8_SIZE = 32
INT8_GATED = {"transatt_unet": 18, "unet_transformer": 14}
INT8_MEMBER = {"transatt_unet": "transatt_unet", "unet_transformer": "unet_transformer_small"}


@functools.lru_cache(maxsize=None)
def calibrated(name):
    """Two seeded INT8_SIZE batches and JAX's ``quant`` collection from them
    (its ``calibrate_int8`` on the member's variables)."""
    c = member(INT8_MEMBER[name])
    rng = np.random.default_rng(INT8_SIZE)
    xs = [rng.standard_normal((1, INT8_SIZE, INT8_SIZE, 3)).astype(np.float32) * s
          for s in (1.0, 1.5)]
    vq = jax_calibrate_int8(c["m"], c["v"], [jnp.asarray(x) for x in xs])
    return xs, jax.tree_util.tree_map(np.asarray, vq["quant"])


@pytest.mark.parametrize("name", sorted(INT8_GATED))
def test_int8_calibration_matches_jax(name):
    """calibrate_int8 records exactly the 18 and 14 gated convs JAX's
    ``quant`` collection holds, with the same maxima to float rounding."""
    c = member(INT8_MEMBER[name])
    xs, quant = calibrated(name)
    stats = calibrate_int8(port_of(c), [_nchw(x) for x in xs])
    want = quant_from_jax(name, quant)
    assert len(stats) == len(want) == len(jax.tree_util.tree_leaves(quant)) == INT8_GATED[name]
    assert sorted(stats) == sorted(want)
    for k in want:
        np.testing.assert_allclose(stats[k].item(), want[k].item(), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(INT8_GATED))
def test_int8_every_gated_conv_matches_jax(name, monkeypatch):
    """The int8 model on JAX's statistics: every gated conv's output equals
    JAX's ``_QuantConv`` (op by op) on the same input, weights and absmax,
    bit for bit; the launch shapes are the ones ``chip_smoke.py`` expects
    (``int8_conv_plan.launch_shapes`` at INT8_SIZE, B=1). The whole int8
    forward, with the same plain int8 convs on JAX's side, stays within the
    float distance a flipped quantisation step moves it (rel L2 0.1)."""
    from unet_zoo_tpu_torch.probes.int8_conv_plan import launch_shapes

    c = member(INT8_MEMBER[name])
    xs, quant = calibrated(name)
    stats = quant_from_jax(name, quant)
    port = port_of(c)
    calls = []
    gated = blocks.gated_conv

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
    assert len(calls) == INT8_GATED[name]
    served = {m: n for n, m in port.module.named_modules()}
    for x, conv_m, y in calls:
        k = conv_m.weight.detach().numpy().transpose(2, 3, 1, 0)
        params = {"kernel": jnp.asarray(k), "bias": jnp.asarray(conv_m.bias.detach().numpy())}
        want = _QuantConv(conv_m.out_channels).apply(
            {"params": params}, jnp.asarray(_nhwc(x)), jnp.float32(stats[served[conv_m]]))
        np.testing.assert_array_equal(_nhwc(y), np.asarray(want), err_msg=served[conv_m])
    shapes = sorted((1, *x.shape[2:], x.shape[1], conv_m.out_channels, conv_m.stride[0])
                    for x, conv_m, _ in calls)
    assert shapes == sorted(r[:6] for r in launch_shapes(name, INT8_SIZE, 1)
                            for _ in range(r[6]))
    with jax.disable_jit():
        jax_int8 = np.asarray(c["m"].module.apply({**c["v"], "quant": quant},
                                                  jnp.asarray(xs[0]), train=False)["main"])
    assert _rel(got, jax_int8) <= 0.1, _rel(got, jax_int8)
    assert _rel(got, c["apply"](c["v"], jnp.asarray(xs[0]))["main"]) > 1e-3


def test_int8_serving_refuses_multiresunet():
    """JAX gates every MultiRes conv-BN unit, 1x1 shortcuts included, and
    serves them int8; the port's int8 conv takes 3x3 convs, so the predictor
    raises naming the first 1x1 conv, before anything is served."""
    port = create_model("multiresunet", device="cpu", filters=8)
    stats = calibrate_int8(port, [torch.randn(1, 3, 32, 32)])
    first = "multiresblock1.conv2d_bn_1x1.conv1"
    assert next(iter(stats)) == first and len(stats) == 9 * 4 + (4 + 3 + 2 + 1) * 2 + 1
    with pytest.raises(ValueError, match=first.replace(".", r"\.") + ": the int8 conv takes"):
        make_predictor(port, None, "logits", quant=stats)
    assert not any(hasattr(m, "int8") for m in port.module.modules())


def test_jax_gates_the_same_convs():
    """JAX's calibration of multiresunet records a statistic for every
    ConvNormAct, as many as the port's gated conv-BN units."""
    m, v = jax_member_variables("multiresunet", 32, filters=8)
    vq = jax_calibrate_int8(m, v, [jnp.zeros((1, 32, 32, 3))])
    port = create_model("multiresunet", device="cpu", filters=8)
    stats = calibrate_int8(port, [torch.randn(1, 3, 32, 32)])
    assert len(jax.tree_util.tree_leaves(vq["quant"])) == len(stats)
