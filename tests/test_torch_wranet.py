"""wranet in the port against the JAX package (CPU).

The port's ``ops/deform.py::deform_conv2d`` (the module path) is held against
the JAX ``ops/deform.py`` (XLA path), and K8's plain version against the JAX
Pallas kernel ``deform_conv2d_pallas`` in interpret mode, with offsets that
reach past every edge of the frame. The CUDA kernel itself is held against
the plain version by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` on the card. The whole model (f32) runs against the JAX
eval forward with nonzero offset and modulator weights on both sides: at
init they are zero, and the deformable conv is then a plain conv times 0.5.
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
from unet_zoo_tpu.models import wranet as jwra
from unet_zoo_tpu.ops import deform as jax_deform
from unet_zoo_tpu.ops.pallas import deform as jax_k8
from unet_zoo_tpu.train.steps import TrainState as JaxTrainState
from unet_zoo_tpu.train.steps import make_optimizer as jax_make_optimizer
from unet_zoo_tpu.train.steps import make_train_step as jax_make_train_step
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.models import wranet as pwra
from unet_zoo_tpu_torch.ops import deform as port_deform
from unet_zoo_tpu_torch.ops.kernels import deform as k8
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
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


def _deform_case(seed, b, h, w, c, o, scale, k=3, stride=1, dilation=1):
    """x, offsets of std ``scale`` pixels, sigmoid masks, weight, bias."""
    rng = np.random.default_rng(seed)
    ho = (h + 2 - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 - dilation * (k - 1) - 1) // stride + 1
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    offset = (scale * rng.standard_normal((b, ho, wo, 2 * k * k))).astype(np.float32)
    mask = (1 / (1 + np.exp(-2 * rng.standard_normal((b, ho, wo, k * k))))).astype(np.float32)
    weight = (rng.standard_normal((k, k, c, o)) / np.sqrt(9 * c)).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    return x, offset, mask, weight, bias


def _max_err(got, want):
    return np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max()


# --- the module path: ops/deform.py ------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(b=2, h=9, w=11, c=5, o=4, scale=1.5),
    dict(b=1, h=8, w=8, c=4, o=3, scale=20.0),             # far past every edge: clamps
    dict(b=2, h=12, w=10, c=6, o=5, scale=2.0, stride=2, dilation=2),
])
def test_deform_conv2d_matches_jax_f32(case):
    """float32, within 1e-5 of the output's largest magnitude."""
    kw = {k: case.pop(k) for k in ("stride", "dilation") if k in case}
    x, off, m, wt, bias = _deform_case(0, **case, **kw)
    want = np.asarray(jax_deform.deform_conv2d(*map(jnp.asarray, (x, off, m, wt, bias)), **kw))
    got = port_deform.deform_conv2d(*map(_t, (x, off, m, wt, bias)), **kw).numpy()
    assert got.shape == want.shape
    assert _max_err(got, want) <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("scale", [1.5, 20.0])
def test_deform_conv2d_matches_jax_bf16(scale):
    """bfloat16 x and weight (corner weights and the blended column in bf16,
    the tap sums in f32), f32 offsets and masks: the two round the same
    values, so they agree to a bf16 ulp of the output's largest magnitude
    (2^-7) beyond which only a column element rounded the other way moves
    them."""
    x, off, m, wt, bias = _deform_case(1, 2, 10, 9, 16, 8, scale)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax_deform.deform_conv2d(bf(x), jnp.asarray(off), jnp.asarray(m),
                                               bf(wt), bf(bias)).astype(jnp.float32))
    tb = lambda a: _t(a).to(torch.bfloat16)
    got = port_deform.deform_conv2d(tb(x), _t(off), _t(m), tb(wt), tb(bias))
    assert got.dtype == torch.bfloat16
    assert _max_err(got.float().numpy(), want) <= 2 ** -7 * np.abs(want).max()


def test_deform_conv2d_grads_at_zero_offsets_match_jax_vjp():
    """float32, zero offsets: every border tap samples exactly on the
    frame's bound (-1 or H, W), where ``jnp.clip`` passes half the gradient.
    The gradients with respect to x, offset and mask match JAX's VJP within
    1e-5 of each one's largest magnitude (``torch.clamp``, which passes all
    of it, puts the offset gradient 0.5 of its largest entry away)."""
    x, _, m, wt, bias = _deform_case(9, 2, 7, 6, 5, 4, 1.0)
    off = np.zeros((2, 7, 6, 18), np.float32)
    g = np.random.default_rng(10).standard_normal((2, 7, 6, 4)).astype(np.float32)
    vjp = jax.jit(lambda g_, *a: jax.vjp(
        lambda *b: jax_deform.deform_conv2d(*b, jnp.asarray(bias)), *a)[1](g_)[:3])
    want = [np.asarray(a) for a in vjp(*map(jnp.asarray, (g, x, off, m, wt)))]
    args = [_t(a).requires_grad_(i < 3) for i, a in enumerate((x, off, m, wt))]
    port_deform.deform_conv2d(*args, _t(bias)).backward(_t(g))
    for name, a, w in zip(("x", "offset", "mask"), args, want):
        assert np.abs(w).max() > 0, name
        assert _max_err(a.grad.numpy(), w) <= 1e-5 * np.abs(w).max(), name


# --- K8's plain version against the JAX Pallas kernel -----------------------------------


K8_CASES = [
    dict(b=1, h=6, w=7, c=3, o=4, scale=1.5),
    dict(b=2, h=16, w=32, c=64, o=48, scale=2.5),          # two channel blocks of the grid
    dict(b=1, h=8, w=8, c=4, o=4, scale=20.0),             # far past every edge: clamps
    dict(b=1, h=17, w=13, c=40, o=24, scale=3.0),          # odd sizes
]


@pytest.mark.parametrize("case", K8_CASES)
def test_k8_reference_matches_jax_kernel_f32(case):
    """float32: the JAX kernel in interpret mode, within 1e-5 of the output's
    largest magnitude (the tap sums run in another order)."""
    x, off, m, wt, bias = _deform_case(2, **case)
    want = np.asarray(jax_k8.deform_conv2d_pallas(*map(jnp.asarray, (x, off, m, wt, bias)),
                                                  interpret=True))
    got = k8.deform_conv2d(*map(_t, (x, off, m, wt, bias))).numpy()
    assert got.shape == want.shape
    assert _max_err(got, want) <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", [K8_CASES[1], K8_CASES[3]])
def test_k8_reference_matches_jax_kernel_bf16(case):
    """bfloat16 x, weight, offsets and masks: the blended rows are rounded to
    bf16 once on both sides, the taps summed in f32; they agree to a bf16
    ulp of the output's largest magnitude (2^-7)."""
    x, off, m, wt, bias = _deform_case(3, **case)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(jax_k8.deform_conv2d_pallas(bf(x), bf(off), bf(m), bf(wt), bf(bias),
                                                  interpret=True).astype(jnp.float32))
    tb = lambda a: _t(a).to(torch.bfloat16)
    got = k8.deform_conv2d(tb(x), tb(off), tb(m), tb(wt), tb(bias))
    assert got.dtype == torch.bfloat16
    assert _max_err(got.float().numpy(), want) <= 2 ** -7 * np.abs(want).max()


def test_k8_argument_errors_name_module_path():
    bf = torch.bfloat16
    x = torch.zeros(2, 8, 9, 16, dtype=bf)
    off = torch.zeros(2, 8, 9, 18, dtype=bf)
    m = torch.zeros(2, 8, 9, 9, dtype=bf)
    wt = torch.zeros(3, 3, 16, 32, dtype=bf)
    good = dict(x=x, offset=off, mask=m, weight=wt, bias=torch.zeros(32), stride=1, padding=1,
                dilation=1)
    assert k8._check_kernel_args(**good) == (2, 8, 9, 16, 8, 9, 32, 3, 3)
    bad = [dict(x=x.float()),                                  # x not bf16
           dict(offset=off.float()),                           # offset not bf16
           dict(mask=torch.zeros(2, 8, 9, 8, dtype=bf)),       # mask's taps
           dict(offset=torch.zeros(2, 4, 9, 18, dtype=bf)),    # offset's pixels
           dict(weight=torch.zeros(3, 3, 8, 32, dtype=bf)),    # weight's channels
           dict(weight=torch.zeros(3, 3, 16, 200, dtype=bf)),  # O above 128
           dict(x=x.transpose(1, 2).contiguous().transpose(1, 2)),   # not contiguous
           dict(bias=torch.zeros(16))]                         # bias's shape
    for change in bad:
        with pytest.raises(ValueError, match="use_kernels=False"):
            k8._check_kernel_args(**{**good, **change})
    with pytest.raises(ValueError, match="cuda or cpu"):
        k8.deform_conv2d(x.to("meta"), off, m, wt)


def test_k8_tile_geometry():
    """O rounds up to the accumulator's 32, 64 or 128 columns; the shared
    memory is the weight slots (all nine taps resident at wranet's shape)
    and each of the 16 warps' [16, C + 8] row tile and 16 samples of 48
    bytes (four corner weights and four corner pointers)."""
    assert [k8.n_tiles(o) for o in (1, 16, 17, 24, 32, 33, 64, 100, 128)] == [
        4, 4, 4, 4, 4, 8, 8, 16, 16]
    assert k8.smem_bytes(128, 1, 9, 4) == 9 * 128 * 40 * 2 + 16 * 16 * (136 * 2 + 48)
    assert k8.smem_bytes(128, 1, 1, 4) == 128 * 40 * 2 + 16 * 16 * (136 * 2 + 48)


# --- modules --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_instance_norm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = (3 + 2 * rng.standard_normal((2, 7, 9, 5))).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jwra.InstanceNorm().apply({}, xj).astype(jnp.float32))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = _nhwc(pwra.instance_norm(_nchw(np.asarray(xj.astype(jnp.float32))).to(tdt)))
    tol = 1e-5 if dtype == jnp.float32 else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_pixel_shuffle_matches_jax():
    """torch's channel order: output channel c takes input channels
    c * 4 + (2 * dy + dx)."""
    x = np.arange(2 * 3 * 5 * 8, dtype=np.float32).reshape(2, 3, 5, 8)
    want = np.asarray(jwra._pixel_shuffle(jnp.asarray(x), 2))
    got = _nhwc(pwra._pixel_shuffle(_nchw(x), 2))
    np.testing.assert_array_equal(got, want)


def _draw_offsets(rng, p):
    """Offset and modulator conv weights off their zero init, so that
    offsets reach a few pixels and masks spread over (0, 1)."""
    for key, sub in p.items():
        if not isinstance(sub, dict):
            continue
        if key in ("offset_conv", "modulator_conv"):
            fan_in = np.prod(sub["kernel"].shape[:3])
            std = (3.0 if key == "offset_conv" else 1.5) / np.sqrt(fan_in)
            sub["kernel"] = (std * rng.standard_normal(sub["kernel"].shape)).astype(np.float32)
            sub["bias"] = (0.5 * rng.standard_normal(sub["bias"].shape)).astype(np.float32)
        else:
            _draw_offsets(rng, sub)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_deformable_conv_matches_jax(use_kernels):
    """The module with offsets drawn off zero: module path and kernel path
    (the plain K8 on the CPU), f32: 1e-5 of the output's largest magnitude."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 12, 8)).astype(np.float32)
    jm = jwra.DeformableConv(6, use_bias=True, use_pallas=False)
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    v["params"]["bias"] = rng.standard_normal(6).astype(np.float32)
    _draw_offsets(rng, {"d": v["params"]})
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = pwra.DeformableConv(8, 6, use_bias=True, use_kernels=use_kernels).eval()
    sd = {}
    from unet_zoo_tpu_torch.utils import convert as port_convert
    port_convert._conv(sd, "offset_conv", v["params"]["offset_conv"])
    port_convert._conv(sd, "modulator_conv", v["params"]["modulator_conv"])
    port_convert._conv(sd, "conv", {"kernel": v["params"]["weight"], "bias": v["params"]["bias"]})
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _nhwc(pm(_nchw(x)))
    assert _max_err(got, want) <= 1e-5 * np.abs(want).max()


# --- the whole model ----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init():
    """A JAX wranet (feature_channels 32, XLA path) and its seed-0 variables
    for a batch of two 32px images, as numpy arrays."""
    m = jax_create_model("wranet", feature_channels=32, use_pallas=False)
    v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3))))
    return m, jax.tree_util.tree_map(np.asarray, v)


@functools.lru_cache(maxsize=None)
def _jax_case():
    """The seed-0 JAX wranet with the offset and modulator convs drawn off
    zero and BatchNorm off identity, a 32px input and its eval logits."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    m, v = _jax_init()
    v = jax.tree_util.tree_map(np.asarray, v)       # a fresh tree: the draws below replace leaves
    _draw_offsets(rng, v["params"])
    for e in (1, 2, 3):
        alpha = v["params"][f"enc{e}_wrarb"]["alpha"]
        v["params"][f"enc{e}_wrarb"]["alpha"] = rng.uniform(0.5, 1.5, alpha.shape).astype(
            np.float32)
    for lv in (1, 2):
        st = v["batch_stats"][f"decoder_lv{lv}"]["conv_3x3_last"]["BatchNorm_0"]
        st["mean"] = (0.1 * rng.standard_normal(st["mean"].shape)).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
    return v, x, np.asarray(apply(v, jnp.asarray(x)))


def _port(v, use_kernels):
    m = create_model("wranet", device="cpu", feature_channels=32, use_kernels=use_kernels)
    m.module.load_state_dict(from_jax_variables("wranet", v), strict=True)
    return m


@pytest.mark.parametrize("use_kernels", [False, True])
def test_eval_logits_match_jax(use_kernels):
    """Module path and kernel path (the plain K8 on the CPU), f32, 32px, with
    nonzero offsets and masks, against the JAX eval logits: 1e-3. The CPU
    launches no kernel."""
    v, x, ref = _jax_case()
    before = k8.LAUNCHES["deform_conv2d"]
    with torch.no_grad():
        got = _nhwc(_port(v, use_kernels).module(_nchw(x))["main"])
    assert got.shape == ref.shape == (2, 32, 32, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert k8.LAUNCHES["deform_conv2d"] == before


def test_kernel_path_calls_k8_twice(monkeypatch):
    calls = []
    real = k8.deform_conv2d
    monkeypatch.setattr(k8, "deform_conv2d",
                        lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    m = create_model("wranet", device="cpu", feature_channels=32, use_kernels=True)
    with torch.no_grad():
        m.module(torch.randn(1, 3, 32, 32))
    assert calls == [(1, 16, 16, 32), (1, 32, 32, 32)]


def test_state_dict_round_trip():
    """The port's state_dict read back by the JAX package's converter gives
    the JAX variables, every leaf exact (strict load both ways)."""
    v, _, _ = _jax_case()
    sd = _port(v, None).module.state_dict()
    back = convert_state_dict("wranet", {k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)
                         for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_registry_defaults():
    assert "wranet" in list_models()
    m, jax_spec = create_model("wranet", device="cpu"), JAX_REGISTRY["wranet"]
    assert (m.spec.requires_image_size, m.spec.default_image_size) == (
        jax_spec.requires_image_size, jax_spec.default_image_size)
    mod = m.module
    assert mod.convblock_1[1].out_channels == 128
    rdb = mod.decoder_lv1.rdb.convs[0]
    assert tuple(rdb.conv.weight.shape) == (32, 128, 3, 3)
    assert rdb.offset_conv.weight.abs().max() == 0 and rdb.modulator_conv.weight.abs().max() == 0
    assert mod.encoder_block_1.lite_wragb.alpha.abs().max() == 0


def test_wranet_trains_on_module_path(monkeypatch):
    """Training runs the module path (K8 has no backward; gradients reach
    the offset and modulator convs through the sampling weights): the loss
    falls over 3 steps on a fixed batch, and the kernel path is never taken."""
    from unet_zoo_tpu_torch.train import create_train_state, make_train_step

    torch.manual_seed(0)
    m = create_model("wranet", device="cpu", feature_channels=32, use_kernels=True)
    state, step = create_train_state(m, learning_rate=1e-3), make_train_step(m)
    images = torch.randint(0, 256, (2, 3, 32, 32), dtype=torch.uint8)
    masks = (torch.rand(2, 1, 32, 32) > 0.5).to(torch.uint8)
    calls = []
    real = k8.deform_conv2d
    monkeypatch.setattr(k8, "deform_conv2d", lambda *a: calls.append(1) or real(*a))
    losses = [float(step(state, images, masks)["loss"]) for _ in range(3)]
    offset_w = m.module.decoder_lv1.rdb.convs[0].offset_conv.weight
    assert np.isfinite(losses).all() and losses[-1] < losses[0] and calls == []
    assert offset_w.abs().max() > 0          # moved off its zero init


# --- one train step -------------------------------------------------------------------


def _adam_first_moment(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)).mu


@pytest.fixture(scope="module")
def jax_wranet_step():
    """JAX ``wranet`` (feature_channels 32, 32px, XLA path) from its seed-0
    variables, as initialised (offset and modulator convs at zero; the
    optimizer of ``create_train_state``), one make_train_step on a seeded
    uint8 batch of 2: initial variables, metrics and the clipped gradient
    (AdamW's first moment after one step is 0.1 times it)."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    masks = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.uint8)
    m, init = _jax_init()
    state = JaxTrainState.create(apply_fn=m.module.apply, params=init["params"],
                                 batch_stats=init["batch_stats"], tx=jax_make_optimizer(1e-4))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    state, metrics = jax_make_train_step(m)(state, jnp.asarray(images), jnp.asarray(masks))
    grads = jax.tree_util.tree_map(lambda mu: mu / 0.1, as_np(_adam_first_moment(state.opt_state)))
    return (images, masks, init, {k: float(v) for k, v in metrics.items()},
            from_jax_variables("wranet", {"params": grads, "batch_stats": init["batch_stats"]}))


def test_wranet_train_step_grads_match_jax(jax_wranet_step):
    """One port step on the module path, float32, from JAX's initial
    variables and batch: loss and Dice at 1e-5, every clipped first-step
    gradient within 1e-3 of its tensor's largest entry. At init every
    border tap of the deformable convs samples exactly on the frame's
    bound, so the offset convs' gradients hinge on the clamp's tie rule
    (``torch.clamp`` put them 4-8% of their largest entry away)."""
    images, masks, init, metrics, grads_ref = jax_wranet_step
    model = create_model("wranet", device="cpu", feature_channels=32)
    model.module.load_state_dict(from_jax_variables("wranet", init), strict=True)
    got = make_train_step(model)(create_train_state(model), _nchw(images), _nchw(masks))
    np.testing.assert_allclose(got["loss"].item(), metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dice"].item(), metrics["dice"], rtol=1e-5)
    names = []
    for name, p in model.module.named_parameters():
        g_ref = grads_ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0,
                                   atol=1e-3 * np.abs(g_ref).max() + 1e-7, err_msg=f"grad {name}")
        names.append(name)
    assert "decoder_lv1.rdb.convs.0.offset_conv.weight" in names
