"""da_transformer in the port against the JAX package (CPU, float32), with
its modules alone (StdConv, DAPam, DACam, DANetHead) and its int8 serving.

The variables come from ``jax.eval_shape`` of JAX's init, every leaf drawn
from a numpy generator (``test_torch_conv_members.jax_member_variables``),
and enter the port through ``from_jax_variables``. The six attention gammas
start at zero, which would keep PAM and CAM out of the logits, so every
comparison sets them to PAM_GAMMA on both sides. The model is held at 64px
with ``block_units=(1, 1, 1)`` (its decoder widths are fixed at 1024 to 64
channels, so even that is 34 M parameters); there the decoder crops by 4
(2 a side), 1 (the low side) and 15 (8 low, 7 high).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_core_members as core
from test_torch_conv_members import PAM_GAMMA, jax_member_variables, jax_module_variables
from test_torch_core_members import _nchw, _nhwc, _rel
from unet_zoo_tpu.nn.blocks import _QuantConv
from unet_zoo_tpu.ops import adaptive_avg_pool2d as jax_adaptive_avg_pool2d
from unet_zoo_tpu.ops import pad_to_match as jax_pad_to_match
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8
from unet_zoo_tpu_torch import create_model, get_model_config
from unet_zoo_tpu_torch.models.da_transformer import DACam, DANetHead, DAPam, StdConv
from unet_zoo_tpu_torch.nn import blocks
from unet_zoo_tpu_torch.ops import adaptive_avg_pool2d, pad_to_match
from unet_zoo_tpu_torch.utils.convert import from_jax_variables, quant_from_jax
from unet_zoo_tpu_torch.utils.serving import calibrate_int8

torch.set_num_threads(1)

SIZE = 64
SMALL = {"config": {"resnet": {"num_layers": (1, 1, 1), "width_factor": 1}}}
GAMMAS = [f"{kind}{i}" for kind in ("pam", "cam") for i in (1, 2, 3)]


def with_gammas(v, value=PAM_GAMMA):
    for name in GAMMAS:
        v["params"][name]["gamma"] = np.full((1,), value, np.float32)
    return v


@functools.lru_cache(maxsize=None)
def member():
    """The JAX model at SIZE with block_units (1, 1, 1), its variables
    (gammas at PAM_GAMMA), a seeded batch of 2 and JAX's eval logits."""
    m, v = jax_member_variables("da_transformer", SIZE, **SMALL)
    v = with_gammas(v)
    x = np.random.default_rng(SIZE).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False))
    want = {k: np.asarray(o) for k, o in apply(v, jnp.asarray(x)).items()}
    return dict(name="da_transformer", kw=SMALL, m=m, v=v, x=x, apply=apply, want=want)


def port_of(c):
    return core.port_model(c["name"], c["v"], **c["kw"])


def test_forward_matches_jax():
    """Eval logits within 1e-3 rel L2 of JAX's, at the input's size."""
    core.check_forward(member())


def test_the_attentions_enter_the_logits():
    """With the six gammas at zero (their init) the logits move by more than
    1e-2: PAM and CAM are exercised by the forward check."""
    c = member()
    port = port_of(c)
    with torch.no_grad():
        for name in GAMMAS:
            getattr(port.module, name).gamma.zero_()
        got = _nhwc(port.module(_nchw(c["x"]))["main"])
    assert _rel(got, c["want"]["main"]) > 1e-2


def test_converters_invert_jax_converters():
    """from_jax_variables inverts JAX's ``convert_da_transformer`` (the
    original zoo's names) exactly, both ways, at block_units (1, 2, 1)."""
    kw = {"config": {"resnet": {"num_layers": (1, 2, 1), "width_factor": 1}}}
    port = create_model("da_transformer", device="cpu", seed=3, **kw)
    sd = port.module.state_dict()
    v = convert_state_dict("da_transformer", dict(sd))
    back = from_jax_variables("da_transformer", v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    again = convert_state_dict("da_transformer", back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, v)


def test_train_step_matches_jax():
    """One step from the same variables and batch: loss and Dice at 1e-5,
    every gradient within 1e-2 of its tensor's largest entry and the running
    statistics at 1e-5 of JAX's (``check_train_step``, directly: no ReLU or
    max pool of this step takes another branch in float32)."""
    core.check_train_step(member(), conditioned=False)


def test_registry_default_builds_at_full_depth():
    """The registry default (block units (3, 4, 9)) builds, counts JAX's
    44.12 M parameters, and gives 63 x 63 skips at 256px (the root pool has
    no padding); only the ResNet's depth and width come from the config."""
    port = create_model("da_transformer", device="cpu")
    n = sum(p.numel() for p in port.module.parameters())
    assert abs(n / 1e6 - 44.12) < 0.01, n
    assert [len(b) for b in port.module.resnet.body.values()] == [3, 4, 9]
    with torch.device("meta"):
        x = torch.zeros(1, 3, 256, 256)
        _, skips = port.module.to("meta").resnet(x)
    assert [tuple(s.shape[1:]) for s in skips] == [(1024, 16, 16), (512, 32, 32),
                                                   (256, 63, 63), (64, 63, 63)]
    cfg = get_model_config("da_transformer")
    cfg["hidden_size"], cfg["transformer"]["num_layers"] = 7, 1
    other = create_model("da_transformer", device="cpu", config=cfg)
    assert sum(p.numel() for p in other.module.parameters()) == n


# --- modules ---------------------------------------------------------------------


@pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (1, 2, 0), (3, 2, 1), (7, 2, 3)])
def test_std_conv_matches_jax(k, stride, pad):
    """The weight standardised per output channel (biased variance, eps
    1e-5), then the conv; the gradient through the standardisation too."""
    from unet_zoo_tpu.models.da_transformer import StdConv as JaxStdConv

    x = np.random.default_rng(k).standard_normal((2, 13, 11, 6)).astype(np.float32)
    j = JaxStdConv(10, k, stride, pad)
    v = jax_module_variables(j, jnp.asarray(x), seed=k)
    want = np.asarray(j.apply(v, jnp.asarray(x)))
    port = StdConv(6, 10, k, stride, pad)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
    got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)
    got.square().sum().backward()
    jax_grad = jax.grad(lambda p: jnp.sum(j.apply({"params": p}, jnp.asarray(x)) ** 2))(
        v["params"])["kernel"]
    g = np.asarray(jax_grad).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(port.weight.grad.numpy(), g, rtol=0,
                               atol=1e-4 * np.abs(g).max())


@pytest.mark.parametrize("hw,res", [((16, 16), (64, 64)), ((15, 13), (32, 32)),
                                    ((8, 8), (8, 8))])
def test_dapam_matches_jax(hw, res):
    """PAM up-sizing (16 -> 64: the pooled maps enlarged), shrinking an odd
    map (15 x 13 -> 32 x 32 enlarges too; 63 x 63 -> 32 x 32 in the served
    model) and at its own size, gamma 0.5."""
    from unet_zoo_tpu.models.da_transformer import DAPam as JaxPam

    x = np.random.default_rng(hw[0]).standard_normal((2, *hw, 32)).astype(np.float32)
    j = JaxPam(res)
    v = jax_module_variables(j, jnp.asarray(x))
    v["params"]["gamma"] = np.full((1,), PAM_GAMMA, np.float32)
    want = np.asarray(j.apply(v, jnp.asarray(x)))
    port = DAPam(32, res)
    sd = {}
    from unet_zoo_tpu_torch.utils import convert

    for n in ("query_conv", "key_conv", "value_conv"):
        convert._conv(sd, n, v["params"][n])
    sd["gamma"] = torch.tensor([PAM_GAMMA])
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size_in,size_out", [((16, 16), (64, 64)), ((32, 32), (64, 64)),
                                              ((63, 63), (32, 32)), ((127, 127), (32, 32))])
def test_adaptive_avg_pool2d_matches_jax_at_pam_sizes(size_in, size_out):
    """The port's pooling equals JAX's two-matmul form where PAM uses it:
    up-sizing 16 and 32 to 64, odd maps (63 at 256px, 127 at 512px) to 32."""
    x = np.random.default_rng(size_in[0]).standard_normal((2, *size_in, 4)).astype(np.float32)
    want = np.asarray(jax_adaptive_avg_pool2d(jnp.asarray(x), size_out))
    got = adaptive_avg_pool2d(_nchw(x), size_out)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_dacam_matches_jax():
    """CAM: softmax over the channels of (row max - X^T X), gamma 0.5."""
    from unet_zoo_tpu.models.da_transformer import DACam as JaxCam

    x = np.random.default_rng(5).standard_normal((2, 15, 15, 24)).astype(np.float32) * 0.3
    v = {"params": {"gamma": np.full((1,), PAM_GAMMA, np.float32)}}
    want = np.asarray(JaxCam().apply(v, jnp.asarray(x)))
    port = DACam()
    port.load_state_dict({"gamma": torch.tensor([PAM_GAMMA])}, strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_dacam_keeps_its_energies_in_float32():
    """In bfloat16 CAM forms X^T X and its softmax in float32 and casts the
    attention once: its output equals the float32 computation on the same
    bf16 input, rounded once through the bf16 product, far closer than a
    bf16 energy (whose softmax of max - energy is near one-hot) gets."""
    x = torch.randn(2, 32, 16, 16, generator=torch.Generator().manual_seed(0)) * 2
    xb = x.to(torch.bfloat16)
    cam = DACam()
    with torch.no_grad():
        cam.gamma.fill_(1.0)
        got = cam(xb).float()
        f = xb.float().flatten(2)
        e = f @ f.transpose(1, 2)
        attn = torch.softmax(e.amax(-1, keepdim=True) - e, dim=-1)
        want = ((attn.to(torch.bfloat16) @ xb.flatten(2)).view_as(xb) + xb).float()
        eb = xb.flatten(2) @ xb.flatten(2).transpose(1, 2)
        attn_b = torch.softmax(eb.amax(-1, keepdim=True) - eb, dim=-1)
        bf16_energy = ((attn_b @ xb.flatten(2)).view_as(xb) + xb).float()
    assert got.dtype == torch.float32 and cam(xb).dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert _rel(bf16_energy.numpy(), want.numpy()) > _rel(got.numpy(), want.numpy())


@pytest.mark.parametrize("return_aux", [False, True])
def test_danet_head_matches_jax(return_aux):
    """The unused DANet head, eval: the three heads (conv8 alone without
    ``return_aux``), the branches' BatchNorms (eps 1e-3) on drawn running
    statistics, PAM at 16 x 16 tokens enlarged from 12 x 12, gammas 0.5."""
    from unet_zoo_tpu.models.da_transformer import DANetHead as JaxHead

    x = np.random.default_rng(7).standard_normal((2, 12, 12, 128)).astype(np.float32)
    j = JaxHead(3, (16, 16))
    v = jax_module_variables(j, jnp.asarray(x))
    for n in ("sa", "sc"):
        v["params"][n]["gamma"] = np.full((1,), PAM_GAMMA, np.float32)
    want = j.apply(v, jnp.asarray(x), return_aux=return_aux)
    port = DANetHead(128, 3, (16, 16))
    port.load_state_dict(danet_head_state(v), strict=True)
    port.eval()
    with torch.no_grad():
        got = port(_nchw(x), return_aux=return_aux)
    got, want = (got, want) if return_aux else ((got,), (want,))
    assert len(got) == len(want) == (3 if return_aux else 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_danet_head_train_mode_matches_jax():
    """In training, with dropout at rate 0 on both sides: the batch
    statistics, and the running statistics after the step (Flax momentum
    0.05: torch momentum 0.95)."""
    from unet_zoo_tpu.models.da_transformer import DANetHead as JaxHead

    x = np.random.default_rng(8).standard_normal((2, 12, 12, 128)).astype(np.float32)
    j = JaxHead(2, (8, 8))
    v = jax_module_variables(j, jnp.asarray(x))
    for n in ("sa", "sc"):
        v["params"][n]["gamma"] = np.full((1,), PAM_GAMMA, np.float32)
    import flax.linen as fnn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **kw: inputs)
        want, upd = j.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = DANetHead(128, 2, (8, 8))
    port.load_state_dict(danet_head_state(v), strict=True)
    for head in (port.conv6, port.conv7, port.conv8):
        head[0].p = 0.0
    port.train()
    got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    for name, key in (("conv5a", "conv5a_bn"), ("conv51", "conv51_bn")):
        bn = getattr(port, name)[1]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"][key]["mean"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(upd["batch_stats"][key]["var"]), rtol=1e-5,
                                   atol=1e-6)


def danet_head_state(v):
    from unet_zoo_tpu_torch.utils import convert

    p, s, sd = v["params"], v["batch_stats"], {}
    for n in ("conv5a", "conv5c", "conv51", "conv52"):
        convert._conv(sd, f"{n}.0", p[f"{n}_conv"])
        convert._bn(sd, f"{n}.1", p[f"{n}_bn"], s[f"{n}_bn"])
    for n in ("query_conv", "key_conv", "value_conv"):
        convert._conv(sd, f"sa.{n}", p["sa"][n])
    sd["sa.gamma"] = torch.from_numpy(np.asarray(p["sa"]["gamma"]))
    sd["sc.gamma"] = torch.from_numpy(np.asarray(p["sc"]["gamma"]))
    for n in ("conv6", "conv7", "conv8"):
        convert._conv(sd, f"{n}.1", p[n])
    return sd


@pytest.mark.parametrize("diff", [-4, -1, -15, -63, 3, 0])
def test_pad_to_match_crops_as_jax(diff):
    """``pad_to_match`` (negative ``F.pad``) against JAX's slices: the crops
    of the served decoder (4: 2 a side; 1: the low side; 15: 8 low, 7 high;
    63 at 256px: 32 low, 31 high) and a pad."""
    x = np.random.default_rng(abs(diff)).standard_normal((1, 70, 66, 2)).astype(np.float32)
    target = (70 + diff, 66 + diff)
    want = np.asarray(jax_pad_to_match(jnp.asarray(x), target))
    got = _nhwc(pad_to_match(_nchw(x), target))
    assert got.shape == want.shape == (1, *target, 2)
    np.testing.assert_array_equal(got, want)


# --- int8 ------------------------------------------------------------------------


INT8_GATED = 10


@functools.lru_cache(maxsize=None)
def calibrated():
    """Two seeded 64px batches and JAX's ``quant`` collection from them."""
    c = member()
    rng = np.random.default_rng(SIZE + 2)
    xs = [rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32) * s for s in (1.0, 1.5)]
    vq = jax_calibrate_int8(c["m"], c["v"], [jnp.asarray(x) for x in xs])
    return xs, jax.tree_util.tree_map(np.asarray, vq["quant"])


def test_int8_calibration_matches_jax():
    """calibrate_int8 records exactly the ten gated convs of JAX's ``quant``
    collection (the bottleneck's and the four UpSampleDA double convs), with
    the same maxima to float rounding."""
    c = member()
    xs, quant = calibrated()
    stats = calibrate_int8(port_of(c), [_nchw(x) for x in xs])
    want = quant_from_jax("da_transformer", quant)
    assert len(stats) == len(want) == len(jax.tree_util.tree_leaves(quant)) == INT8_GATED
    assert sorted(stats) == sorted(want)
    for k in want:
        np.testing.assert_allclose(stats[k].item(), want[k].item(), rtol=1e-5, err_msg=k)


def test_int8_every_gated_conv_matches_jax(monkeypatch):
    """The int8 model on JAX's statistics: every gated conv equals JAX's
    ``_QuantConv`` (op by op) on the same input, weights and absmax, bit for
    bit; the launch shapes are ``int8_conv_plan.launch_shapes``' (64px, B=1:
    4 x 4 and 15 x 15 maps).

    The whole int8 forward is held to JAX's own int8 forward (op by op, the
    same statistics) relative to how far JAX's int8 lies from its float
    forward, since one activation that float rounding moves across a
    quantisation boundary moves every logit after it: within half that
    distance (read: 3.85e-2 against 1.83e-1); and the port's int8 lies no
    further from its float forward than 1.25 times JAX's does."""
    from unet_zoo_tpu_torch.probes.int8_conv_plan import launch_shapes

    c = member()
    xs, quant = calibrated()
    stats = quant_from_jax("da_transformer", quant)
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
    assert len(calls) == INT8_GATED
    served = {m: n for n, m in port.module.named_modules()}
    for x, conv_m, y in calls:
        k = conv_m.weight.detach().numpy().transpose(2, 3, 1, 0)
        params = {"kernel": jnp.asarray(k), "bias": jnp.asarray(conv_m.bias.detach().numpy())}
        want = _QuantConv(conv_m.out_channels).apply(
            {"params": params}, jnp.asarray(_nhwc(x)), jnp.float32(stats[served[conv_m]]))
        np.testing.assert_array_equal(_nhwc(y), np.asarray(want), err_msg=served[conv_m])
    shapes = sorted((1, *x.shape[2:], x.shape[1], conv_m.out_channels, conv_m.stride[0])
                    for x, conv_m, _ in calls)
    assert shapes == sorted(r[:6] for r in launch_shapes("da_transformer", SIZE, 1)
                            for _ in range(r[6]))
    with jax.disable_jit():
        jax_int8 = np.asarray(c["m"].module.apply({**c["v"], "quant": quant},
                                                  jnp.asarray(xs[0]), train=False)["main"])
    jax_float = np.asarray(c["apply"](c["v"], jnp.asarray(xs[0]))["main"])
    with torch.no_grad():
        port_float = _nhwc(port_of(c).module(_nchw(xs[0]))["main"])
    jax_dist = _rel(jax_int8, jax_float)
    assert jax_dist > 1e-3 and _rel(port_float, jax_float) <= 1e-3
    assert _rel(got, jax_int8) <= 0.5 * jax_dist, (_rel(got, jax_int8), jax_dist)
    assert _rel(got, port_float) <= 1.25 * jax_dist, (_rel(got, port_float), jax_dist)
