"""unext and unext_s in the port against the JAX package (CPU).

K3 (``depthwise_conv2d``): on the CPU the port's wrapper runs its plain
version, held here against the JAX Pallas kernel in interpret mode. The CUDA
kernel itself is held against the plain version by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card. The
transformer modules and both whole models (f32) run against the JAX eval
forward, whose CPU path (the XLA one) is the oracle. DropPath's bfloat16
draw is held bit for bit against JAX's expression.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.nn import transformer as jtr
from unet_zoo_tpu.ops.pallas import depthwise as jax_k3
from unet_zoo_tpu.train.steps import TrainState as JaxTrainState
from unet_zoo_tpu.train.steps import make_optimizer as jax_make_optimizer
from unet_zoo_tpu.train.steps import make_train_step as jax_make_train_step
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.nn import transformer as ptr
from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
from unet_zoo_tpu_torch.utils import convert as port_convert
from unet_zoo_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

CL = torch.channels_last


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _jax_init(module, *args, seed=0):
    v = module.init(jax.random.PRNGKey(seed), *args)
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(v))


def _off_init(rng, p):
    """Every LayerNorm off identity and every bias off zero, in a JAX params dict."""
    for sub in p.values():
        if not isinstance(sub, dict):
            continue
        if set(sub) == {"scale", "bias"}:
            sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape).astype(np.float32)
        if isinstance(sub.get("bias"), np.ndarray):
            sub["bias"] = (0.1 * rng.standard_normal(sub["bias"].shape)).astype(np.float32)
        _off_init(rng, sub)


def _bf16_ulp(a):
    """One bf16 ulp of each value of ``a`` (float32 numpy)."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# --- K3 --------------------------------------------------------------------------


K3_SHAPES = [((2, 16, 16, 8), 3), ((1, 17, 13, 6), 3), ((2, 12, 12, 4), 5), ((1, 15, 15, 2), 7)]


def _k3_case(shape, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((k, k, shape[-1])).astype(np.float32),
            rng.standard_normal((shape[-1],)).astype(np.float32))


@pytest.mark.parametrize("shape,k", K3_SHAPES)
def test_k3_reference_matches_jax_kernel_f32(shape, k):
    """float32: the JAX kernel in interpret mode, within 1e-5 of the
    output's largest magnitude (the same taps summed in the same order)."""
    x, kern, bias = _k3_case(shape, k)
    want = np.asarray(jax_k3.depthwise_conv2d(jnp.asarray(x), jnp.asarray(kern),
                                              jnp.asarray(bias), k=k, interpret=True))
    got = k3.depthwise_conv2d(_t(x), _t(kern), _t(bias)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape,k", K3_SHAPES)
def test_k3_reference_matches_jax_kernel_bf16(shape, k):
    """bfloat16 x, kernel and bias: f32 sums rounded once, so the two agree
    to one bf16 ulp of each output."""
    x, kern, bias = _k3_case(shape, k, seed=1)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax_k3.depthwise_conv2d(bf(x), bf(kern), bf(bias), k=k, interpret=True
                                              ).astype(jnp.float32))
    tb = lambda a: _t(a).to(torch.bfloat16)
    got = k3.depthwise_conv2d(tb(x), tb(kern), tb(bias))
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want) <= _bf16_ulp(want)).all()


def test_k3_reference_without_bias():
    x, kern, _ = _k3_case((1, 8, 8, 4), 3, seed=2)
    want = np.asarray(jax_k3.depthwise_conv2d(jnp.asarray(x), jnp.asarray(kern), None, k=3,
                                              interpret=True))
    np.testing.assert_allclose(k3.depthwise_conv2d(_t(x), _t(kern)).numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


def test_k3_argument_errors_name_module_path():
    x = torch.zeros(2, 8, 8, 16, dtype=torch.bfloat16)
    kern = torch.zeros(3, 3, 16, dtype=torch.bfloat16)
    bias = torch.zeros(16, dtype=torch.bfloat16)
    assert k3._check_kernel_args(x, kern, bias) == (2, 8, 8, 16, 3)
    bad = [dict(x=x.half(), kernel=kern.half(), bias=bias.half()),   # float16
           dict(kernel=kern.float()),                                # kernel's dtype
           dict(kernel=torch.zeros(3, 3, 8, dtype=torch.bfloat16)),  # kernel's channels
           dict(kernel=torch.zeros(9, 9, 16, dtype=torch.bfloat16)), # k 9
           dict(kernel=torch.zeros(4, 4, 16, dtype=torch.bfloat16)), # k even
           dict(bias=torch.zeros(8, dtype=torch.bfloat16)),          # bias's shape
           dict(x=x.transpose(1, 2))]                                # not contiguous
    for change in bad:
        args = {"x": x, "kernel": kern, "bias": bias, **change}
        with pytest.raises(ValueError, match="use_kernels=False"):
            k3._check_kernel_args(**args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k3.depthwise_conv2d(x.to("meta"), kern, bias)


# --- DropPath in bfloat16 ---------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.0571, 0.0143])
def test_drop_path_bf16_matches_jax_bit_for_bit(rate):
    """For every u on JAX's bf16 grid (k / 128), the port's x / keep *
    floor(keep + u) equals JAX's DropPath expression
    (``unet_zoo_tpu/nn/transformer.py:32-33``) on the same u, in bf16: keep
    rounded to bf16 before the sum and the quotient."""
    rng = np.random.default_rng(int(rate * 1e4))
    x = rng.standard_normal((128, 3, 5)).astype(np.float32)
    u = (np.arange(128, dtype=np.float32) / 128.0)[:, None, None]
    keep = 1.0 - rate
    xj, uj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16)
    want = np.asarray((xj / keep * jnp.floor(keep + uj)).astype(jnp.float32))
    got = ptr.drop_path_apply(_t(x).to(torch.bfloat16), rate, _t(u).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    if rate == 0.1:     # JAX's kept share in bf16, off the nominal 0.9
        assert (want != 0).all(axis=(1, 2)).mean() == 115 / 128


def test_drop_path_bf16_draws_on_jax_grid():
    """The port's bf16 draws from a seeded generator lie on JAX's grid k / 128
    and spread evenly over its 128 values (chi-square, 127 degrees of
    freedom, below the 0.999 quantile 181.99 at this fixed seed)."""
    g = torch.Generator().manual_seed(5)
    x = torch.ones(64000, 1, dtype=torch.bfloat16)
    u = ptr._drop_path_uniform((64000, 1), x, g)
    assert u.dtype == torch.bfloat16
    k = u.float().numpy().ravel() * 128
    assert (k == np.round(k)).all() and k.min() >= 0 and k.max() <= 127
    counts = np.bincount(k.astype(np.int64), minlength=128)
    expected = len(k) / 128
    assert ((counts - expected) ** 2 / expected).sum() < 181.99
    # DropPath draws the same u from the same seed
    got = ptr.DropPath(0.1).train()(x, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(got.float().numpy(),
                                  ptr.drop_path_apply(x, 0.1, u).float().numpy())


# --- modules -----------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
def test_dwconv_matches_jax(use_kernels):
    """Module path (grouped conv) and kernel path (the plain K3 on the CPU)
    against JAX's DWConv (XLA grouped conv), f32: 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 7, 12)).astype(np.float32)
    jm = jtr.DWConv()
    v = _jax_init(jm, jnp.asarray(x))
    v["params"]["dwconv"]["bias"] = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = ptr.DWConv(12, use_kernels=use_kernels).eval()
    sd = {}
    port_convert._conv(sd, "dwconv", v["params"]["dwconv"])
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _attn_sd(prefix, a):
    sd = {}
    for name in ("q", "kv", "proj"):
        port_convert._dense(sd, f"{prefix}{name}", a[name])
    if "sr" in a:
        port_convert._conv(sd, f"{prefix}sr", a["sr"])
        port_convert._ln(sd, f"{prefix}norm", a["sr_norm"])
    return sd


@pytest.mark.parametrize("sr", [1, 2])
def test_sr_attention_matches_jax(sr):
    rng = np.random.default_rng(sr)
    x = rng.standard_normal((2, 8, 6, 16)).astype(np.float32)
    jm = jtr.SRAttention(num_heads=2, sr_ratio=sr)
    v = _jax_init(jm, jnp.asarray(x))
    _off_init(rng, v["params"])
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = ptr.SRAttention(16, 2, sr).eval()
    pm.load_state_dict(_attn_sd("", v["params"]), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(pm(_t(x)).numpy(), want, rtol=0, atol=1e-5)


def _block_sd(p):
    sd = {}
    port_convert._ln(sd, "norm1", p["norm1"])
    port_convert._ln(sd, "norm2", p["norm2"])
    sd.update(_attn_sd("attn.", p["attn"]))
    port_convert._dense(sd, "mlp.fc1", p["mlp"]["fc1"])
    port_convert._conv(sd, "mlp.dwconv.dwconv", p["mlp"]["DWConv_0"]["dwconv"])
    port_convert._dense(sd, "mlp.fc2", p["mlp"]["fc2"])
    return sd


@pytest.mark.parametrize("sr,use_kernels", [(1, False), (2, True)])
def test_mit_block_matches_jax(sr, use_kernels):
    rng = np.random.default_rng(10 + sr)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jm = jtr.MiTBlock(num_heads=2, sr_ratio=sr, drop_path=0.1)
    v = _jax_init(jm, jnp.asarray(x))
    _off_init(rng, v["params"])
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = ptr.MiTBlock(16, 2, sr_ratio=sr, drop_path=0.1, use_kernels=use_kernels).eval()
    pm.load_state_dict(_block_sd(v["params"]), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(pm(_t(x)).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("patch,stride,cin", [(7, 4, 3), (3, 2, 8)])
def test_overlap_patch_embed_matches_jax(patch, stride, cin):
    rng = np.random.default_rng(patch)
    x = rng.standard_normal((2, 18, 14, cin)).astype(np.float32)
    jm = jtr.OverlapPatchEmbed(12, patch, stride)
    v = _jax_init(jm, jnp.asarray(x))
    _off_init(rng, v["params"])
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = ptr.OverlapPatchEmbed(cin, 12, patch, stride).eval()
    sd = {}
    port_convert._conv(sd, "proj", v["params"]["proj"])
    port_convert._ln(sd, "norm", v["params"]["norm"])
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _moe_block_sd(p):
    sd = {}
    port_convert._ln(sd, "norm1", p["norm1"])
    port_convert._ln(sd, "norm2", p["norm2"])
    sd.update(_attn_sd("attn.", p["attn"]))
    for name, a in p["moe_mlp"].items():
        sd[f"moe_mlp.{name}"] = _t(a)
    return sd


@pytest.mark.parametrize("sr", [1, 2])
def test_mit_block_with_moe_matches_jax(sr):
    """MiTBlock(moe_experts=4) against JAX's MiT block with the Switch-MoE
    FFN (``moe_mlp``, expert biases drawn off zero), float32, eval: 1e-5. It
    has no depthwise conv, so no K3 on either path."""
    rng = np.random.default_rng(20 + sr)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jm = jtr.MiTBlock(num_heads=2, sr_ratio=sr, moe_experts=4, drop_path=0.1)
    v = _jax_init(jm, jnp.asarray(x))
    _off_init(rng, v["params"])
    for name in ("expert_fc1_bias", "expert_fc2_bias"):
        b = v["params"]["moe_mlp"][name]
        v["params"]["moe_mlp"][name] = (0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = ptr.MiTBlock(16, 2, sr_ratio=sr, drop_path=0.1, moe_experts=4, use_kernels=True).eval()
    pm.load_state_dict(_moe_block_sd(v["params"]), strict=True)
    assert not hasattr(pm, "mlp")
    before = k3.LAUNCHES["depthwise_conv2d"]
    with torch.no_grad():
        np.testing.assert_allclose(pm(_t(x)).numpy(), want, rtol=0, atol=1e-5)
    assert k3.LAUNCHES["depthwise_conv2d"] == before


# --- the whole models -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """A JAX unext/unext_s at registry widths, its variables with every
    LayerNorm and bias off init, a 64px input and its eval logits (XLA path)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    m = jax_create_model(name)
    v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = jax.tree_util.tree_map(np.asarray, v)
    _off_init(rng, v["params"])
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
    return v, x, np.asarray(apply(v, jnp.asarray(x)))


def _port(name, v, use_kernels):
    m = create_model(name, device="cpu", use_kernels=use_kernels)
    m.module.load_state_dict(from_jax_variables(name, v), strict=True)
    return m


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", ["unext_s", "unext"])
def test_eval_logits_match_jax(name, use_kernels):
    """Module path and kernel path (the plain K3 on the CPU), f32, 64px,
    against the JAX eval logits: 1e-3. The CPU launches no kernel."""
    v, x, ref = _jax_case(name)
    before = k3.LAUNCHES["depthwise_conv2d"]
    with torch.no_grad():
        got = _nhwc(_port(name, v, use_kernels).module(_nchw(x))["main"])
    assert got.shape == ref.shape == (2, 64, 64, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert k3.LAUNCHES["depthwise_conv2d"] == before


def test_kernel_path_calls_k3_once_per_block(monkeypatch):
    """use_kernels=True runs K3 in every MiT block: 6 calls per unext_s
    forward (depths 2, 2, 2), each on channels-last [B, H, W, 4C] tokens."""
    calls = []
    real = k3.depthwise_conv2d
    monkeypatch.setattr(k3, "depthwise_conv2d",
                        lambda x, kern, bias: calls.append(tuple(x.shape)) or real(x, kern, bias))
    m = create_model("unext_s", device="cpu", use_kernels=True)
    with torch.no_grad():
        m.module(torch.randn(1, 3, 64, 64))
    assert calls == [(1, 16, 16, 256)] * 2 + [(1, 8, 8, 512)] * 2 + [(1, 4, 4, 640)] * 2
    calls.clear()
    with torch.no_grad():
        create_model("unext_s", device="cpu").module(torch.randn(1, 3, 64, 64))
    assert calls == []      # use_kernels=None: only bf16 CUDA activations


def test_state_dict_round_trip():
    """The port's state_dict read back by the JAX package's converter gives
    the JAX variables, every leaf exact (strict load both ways)."""
    v, _, _ = _jax_case("unext_s")
    sd = _port("unext_s", v, None).module.state_dict()
    back = convert_state_dict("unext_s", {k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)
                         for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- registry ---------------------------------------------------------------------------


def test_registry_lists_unext_family():
    assert {"unext", "unext_s"} <= set(list_models())
    for name in ("unext", "unext_s"):
        spec, jax_spec = create_model(name, device="cpu").spec, JAX_REGISTRY[name]
        assert (spec.requires_image_size, spec.default_image_size) == (
            jax_spec.requires_image_size, jax_spec.default_image_size)
        assert spec.loss_weight("main") == jax_spec.loss_weight("main")


def test_unext_s_pins_its_widths():
    """unext_s drops user widths and depths, as the JAX registry does."""
    m = create_model("unext_s", device="cpu", embed_dims=(8, 8, 8), depths=(1, 1, 1),
                     norm_layer="ignored")
    mod = m.module
    assert [len(getattr(mod, f"block{s}")) for s in (1, 2, 3)] == [2, 2, 2]
    assert [getattr(mod, f"norm{s}").normalized_shape[0] for s in (1, 2, 3)] == [64, 128, 160]
    assert mod.block1[0].attn.sr_ratio == 8 and mod.block3[0].attn.num_heads == 4


def test_unext_keeps_user_values_and_three_stages():
    m = create_model("unext", device="cpu", embed_dims=(16, 24, 32), depths=(1, 2, 1, 5),
                     num_heads=(1, 2, 4, 8))
    mod = m.module
    assert [len(getattr(mod, f"block{s}")) for s in (1, 2, 3)] == [1, 2, 1]
    assert mod.final_conv.in_channels == 16 and mod.decoder_level1.in_channels == 32
    full = create_model("unext", device="cpu").module
    assert [len(getattr(full, f"block{s}")) for s in (1, 2, 3)] == [3, 4, 6]
    assert full.block1[0].mlp.dwconv.dwconv.out_channels == 512
    # moe_experts > 0: block i of a stage has the Switch-MoE FFN where i % 2 == 1
    moe = create_model("unext", device="cpu", moe_experts=4).module
    for s in (1, 2, 3):
        blocks = getattr(moe, f"block{s}")
        assert [hasattr(b, "moe_mlp") for b in blocks] == [i % 2 == 1 for i in range(len(blocks))]
        assert [hasattr(b, "mlp") for b in blocks] == [i % 2 == 0 for i in range(len(blocks))]


def test_unext_s_trains_on_module_path(monkeypatch):
    """Training runs the module path (K3 has no backward), with DropPath
    drawing from the default generator: the loss falls over 5 steps on a
    fixed batch (it rises at step 2 from random weights first), and the
    kernel path is never taken."""
    from unet_zoo_tpu_torch.train import create_train_state, make_train_step

    torch.manual_seed(0)
    m = create_model("unext_s", device="cpu", drop_path_rate=0.1, use_kernels=True)
    state, step = create_train_state(m, learning_rate=1e-4), make_train_step(m)
    images = torch.randint(0, 256, (2, 3, 32, 32), dtype=torch.uint8)
    masks = (torch.rand(2, 1, 32, 32) > 0.5).to(torch.uint8)
    calls = []
    real = k3.depthwise_conv2d
    monkeypatch.setattr(k3, "depthwise_conv2d", lambda *a: calls.append(1) or real(*a))
    losses = [float(step(state, images, masks)["loss"]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0] and calls == []


# --- one train step against JAX ---------------------------------------------------------


def _adam_first_moment(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)).mu


@pytest.mark.parametrize("name,size", [("unext", 64), ("unext_s", 32)])
def test_train_step_matches_jax(name, size):
    """One port step (module path, float32, drop_path_rate 0) from the
    variables of ``_jax_case`` on a seeded uint8 batch of 2 against JAX's
    make_train_step: loss and Dice at 1e-5, every clipped first-step gradient
    (AdamW's first moment over 0.1) within 1e-2 of its tensor's largest
    entry plus 1e-5."""
    v, _, _ = _jax_case(name)
    rng = np.random.default_rng(size)
    images = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    masks = (rng.random((2, size, size, 1)) > 0.5).astype(np.uint8)
    m = jax_create_model(name, drop_path_rate=0.0)
    state = JaxTrainState.create(apply_fn=m.module.apply, params=v["params"], batch_stats={},
                                 tx=jax_make_optimizer(1e-4))
    state, metrics = jax_make_train_step(m)(state, jnp.asarray(images), jnp.asarray(masks))
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1,
                                   _adam_first_moment(state.opt_state))
    grads_ref = from_jax_variables(name, {"params": grads})

    from unet_zoo_tpu_torch.train import create_train_state, make_train_step

    model = create_model(name, device="cpu", drop_path_rate=0.0)
    model.module.load_state_dict(from_jax_variables(name, v), strict=True)
    got = make_train_step(model)(create_train_state(model), _nchw(images), _nchw(masks))
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["dice"].item(), float(metrics["dice"]), rtol=1e-5)
    for pname, p in model.module.named_parameters():
        g_ref = grads_ref[pname].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0,
                                   atol=1e-2 * np.abs(g_ref).max() + 1e-5, err_msg=f"grad {pname}")
