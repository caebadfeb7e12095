"""attention_unet, nested_unet, resunet and u2net_tpu in the port against the
JAX package (CPU, float32), and the rest of ``ops/pooling.py``.

Each model gets the same seeded random variables on both sides: JAX's
variable tree (``jax.eval_shape`` of its init, every leaf drawn from a numpy
generator, BatchNorm off identity) goes into the port through
``from_jax_variables``, which the JAX converters invert where they exist.
Held against JAX: eval logits of every output key (rel L2 1e-3), one
``make_train_step`` (loss and Dice at 1e-5 relative, each output key at its
spec's weight, every clipped gradient within 1e-2 of its tensor's largest
entry plus 1e-5: of JAX's, or where float32 rounding flips ReLUs, of a
float64 copy of the port on the same branches, see ``check_train_step``),
and int8 serving of ``attention_unet``, ``nested_unet`` and, at narrow
widths, ``resunet`` (its 1x1 stride-2 skips) and ``u2net_tpu`` (its
dilated bottleneck): calibration, every gated conv exactly; the whole
model's distance from float against JAX's own.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.nn.blocks import _QuantConv
from unet_zoo_tpu.ops import pooling as jax_pooling
from unet_zoo_tpu.train.steps import TrainState as JaxTrainState
from unet_zoo_tpu.train.steps import make_optimizer as jax_make_optimizer
from unet_zoo_tpu.train.steps import make_train_step as jax_make_train_step
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.nn import blocks
from unet_zoo_tpu_torch.ops import adaptive_avg_pool2d, global_avg_pool, max_pool2d
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.utils.convert import from_jax_variables, quant_from_jax
from unet_zoo_tpu_torch.utils.serving import calibrate_int8, make_predictor

torch.set_num_threads(1)

CL = torch.channels_last


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- pooling -----------------------------------------------------------------


@pytest.mark.parametrize("h,w,window,stride,padding", [
    (5, 7, 2, 2, 0), (11, 44, 2, 2, 0), (45, 45, 2, 2, 0), (7, 9, 3, 2, 1), (9, 6, 3, 3, 0),
    (6, 11, 3, 2, 0), (8, 8, 2, 2, 0),
])
def test_max_pool2d_ceil_mode_matches_jax(h, w, window, stride, padding):
    """Ceil mode pads the high side with -inf by JAX's ``_ceil_pad``: exact,
    and equal to ATen's ceil mode where its rule agrees (no padding)."""
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_pooling.max_pool2d(jnp.asarray(x), window, stride, padding,
                                             ceil_mode=True))
    got = max_pool2d(_nchw(x), window, stride, padding, ceil_mode=True)
    np.testing.assert_array_equal(_nhwc(got), want)
    if padding == 0:
        np.testing.assert_array_equal(
            got.numpy(), F.max_pool2d(_nchw(x), window, stride, ceil_mode=True).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keepdims", [True, False])
def test_global_avg_pool_matches_jax(dtype, keepdims):
    x = np.random.default_rng(3).standard_normal((2, 7, 5, 6)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_pooling.global_avg_pool(jnp.asarray(x, jdt), keepdims)
                      .astype(jnp.float32))
    got = global_avg_pool(_nchw(x).to(dtype), keepdims)
    assert got.dtype == dtype
    got = _nhwc(got) if keepdims else got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == torch.float32 else 2 ** -8,
                               atol=1e-7)


@pytest.mark.parametrize("size_in,size_out", [
    ((11, 45), (4, 7)), ((5, 3), (11, 5)), ((7, 6), (3, 13)), ((9, 9), (9, 4)), ((6, 6), (6, 6)),
])
def test_adaptive_avg_pool2d_matches_jax(size_in, size_out):
    """Down- and up-sizing (bins that overlap), float32 within 1e-6."""
    x = np.random.default_rng(size_in[0]).standard_normal((2, *size_in, 4)).astype(np.float32)
    want = np.asarray(jax_pooling.adaptive_avg_pool2d(jnp.asarray(x), size_out))
    got = adaptive_avg_pool2d(_nchw(x), size_out)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)
    xb = _nchw(x).to(torch.bfloat16)
    assert adaptive_avg_pool2d(xb, size_out).dtype == torch.bfloat16


# --- the models ------------------------------------------------------------------


def _draw(rng, path, shape):
    """A seeded value for one JAX variable: He-scaled kernels, biases and BN
    shifts near zero, BN scales and variances in [0.5, 1.5)."""
    name = path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
    if name in ("scale", "var"):
        return rng.random(shape) + 0.5
    return rng.standard_normal(shape) * 0.1                  # bias, mean


def jax_variables(name, size, seed=0, **kw):
    """The JAX model and its variables {'params', 'batch_stats'} as numpy,
    drawn by _draw over the init's shapes (no init is run)."""
    m = jax_create_model(name, **kw)
    shapes = jax.eval_shape(lambda: m.module.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed)
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    drawn = [_draw(rng, [getattr(k, "key", k) for k in path], leaf.shape).astype(np.float32)
             for path, leaf in leaves]
    v = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), drawn)
    return m, {k: v[k] for k in ("params", "batch_stats")}


def port_model(name, v, **kw):
    port = create_model(name, device="cpu", **kw)
    port.module.load_state_dict(from_jax_variables(name, v), strict=True)
    return port


def build_member(name, size, kw):
    """JAX model, variables, a seeded batch of 2 and its jitted eval outputs."""
    m, v = jax_variables(name, size, **kw)
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False))
    want = {k: np.asarray(o) for k, o in apply(v, jnp.asarray(x)).items()}
    return dict(name=name, kw=kw, m=m, v=v, x=x, apply=apply, want=want)


@functools.lru_cache(maxsize=None)
def member(key):
    """build_member for one configuration of MEMBERS, once per test file."""
    return build_member(*MEMBERS[key])


# (registry name, image size, kwargs); attention_unet at both depths, with its
# int8 model at depth 5 and 64px (at 32px its bottleneck is 2x2); u2net_tpu
# at 128px (its bottleneck at stride 32 is 4x4)
MEMBERS = {
    "attention_unet": ("attention_unet", 64, {}),
    "attention_unet_d4": ("attention_unet", 32, {"depth": 4}),
    "nested_unet": ("nested_unet", 64, {"deep_supervision": True}),
    "nested_unet_single": ("nested_unet", 32, {}),
    "resunet": ("resunet", 32, {}),
    "resunet_narrow": ("resunet", 32, {"filters": (8, 16, 16, 16)}),
    "u2net_tpu": ("u2net_tpu", 128, {}),
    "u2net_tpu_narrow": ("u2net_tpu", 64, {"widths": (16, 16, 16, 16)}),
    "u2net_tpu_bilinear": ("u2net_tpu", 64, {"head_mode": "bilinear"}),
}


def test_registry_lists_the_eighteen_names():
    # eighteen when the core members came in; missformer and unext_moe made
    # 20, raunet, transatt_unet, unet_transformer, multiresunet and vnet 25,
    # the hybrids uctransnet, da_transformer and egeunet 28: JAX's names
    from unet_zoo_tpu.models import list_models as jax_list_models

    names = list_models()
    assert len(names) == 28
    assert names == jax_list_models()
    for name in ("attention_unet", "nested_unet", "u2net", "u2netp", "resunet", "u2net_tpu"):
        assert name in names


@pytest.mark.parametrize("name,kw", [("attention_unet", {}), ("nested_unet", {}),
                                     ("nested_unet", {"deep_supervision": True}),
                                     ("resunet", {})])
def test_converters_invert_jax_converters(name, kw):
    """from_jax_variables inverts the JAX package's converter (the original
    zoo's names) exactly, both ways."""
    port = create_model(name, device="cpu", seed=3, **kw)
    sd = port.module.state_dict()
    v = convert_state_dict(name, dict(sd))
    back = from_jax_variables(name, v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    again = convert_state_dict(name, back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, v)


def check_forward(c):
    """Eval logits of every output key within 1e-3 rel L2 of JAX's, with the
    same keys and shapes."""
    port = port_model(c["name"], c["v"], **c["kw"])
    with torch.no_grad():
        got = port.module(_nchw(c["x"]))
    assert sorted(got) == sorted(c["want"])
    for k, want in c["want"].items():
        assert want.shape == (2, c["x"].shape[1], c["x"].shape[2], 1)
        assert _nhwc(got[k]).shape == want.shape, k
        assert _rel(_nhwc(got[k]), want) <= 1e-3, (k, _rel(_nhwc(got[k]), want))


@pytest.mark.parametrize("key", sorted(MEMBERS))
def test_forward_matches_jax(key):
    check_forward(member(key))


def _adam_first_moment(opt_state):
    import optax

    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)).mu


def float64_copy(port):
    """The port's model computing in float64 (the reference that float32
    conditioning is judged against): its parameters and buffers in float64
    and every layer's compute type float64. Run it inside
    :func:`float64_batch_norm`; the loss and ``u2net_tpu``'s float32 side
    heads stay float32, as their code says."""
    port.module.double()
    for m in port.module.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return port


@contextlib.contextmanager
def float64_batch_norm():
    """Within, ``F.batch_norm`` takes its affine (where it has one) in its
    input's type: the port's ``batch_norm`` hands it a float32 one, which a
    float64 input refuses."""
    bn = F.batch_norm
    cast = lambda t, x: None if t is None else t.to(x.dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "batch_norm", lambda x, mean, var, w, b, *args: bn(
            x, mean, var, cast(w, x), cast(b, x), *args))
        yield


class Branches:
    """A step's branch decisions, each ReLU's signs and each max pool's
    picks, recorded on one run (:meth:`record`) and taken again on another
    (:meth:`replay`): a float64 step that replays the float32 one's follows
    the same piece of the piecewise-linear network, so the two differ by
    float32 rounding alone and not by which side of zero a pre-activation
    within rounding of it fell."""

    def __init__(self):
        self.signs, self.picks = [], []

    @contextlib.contextmanager
    def record(self):
        relu, pool = torch.relu, F.max_pool2d

        def recording_relu(x):
            self.signs.append(x.detach() > 0)
            return relu(x)

        def recording_pool(x, *args, **kw):
            y, picks = pool(x, *args, return_indices=True, **kw)
            self.picks.append(picks)
            return y

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "relu", recording_relu)
            mp.setattr(F, "max_pool2d", recording_pool)
            yield

    @contextlib.contextmanager
    def replay(self):
        signs, picks = iter(self.signs), iter(self.picks)

        def replayed_pool(x, *args, **kw):
            at = next(picks)
            b, ch = x.shape[:2]
            return x.reshape(b, ch, -1).gather(2, at.reshape(b, ch, -1)).view(at.shape)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch, "relu", lambda x: x * next(signs).to(x.dtype))
            mp.setattr(F, "max_pool2d", replayed_pool)
            yield
        assert next(signs, None) is None and next(picks, None) is None


def jax_step(c):
    """One JAX make_train_step from the member's variables on a seeded uint8
    batch of 2: the batch, metrics, and the clipped gradient (AdamW's first
    moment after one step is 0.1 times it) and batch statistics as a port
    state_dict."""
    size = c["x"].shape[1]
    rng = np.random.default_rng(size + 1)
    images = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    masks = (rng.random((2, size, size, 1)) > 0.5).astype(np.uint8)
    state = JaxTrainState.create(apply_fn=c["m"].module.apply, params=c["v"]["params"],
                                 batch_stats=c["v"]["batch_stats"], tx=jax_make_optimizer(1e-4))
    state, metrics = jax_make_train_step(c["m"])(state, jnp.asarray(images), jnp.asarray(masks))
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1,
                                   _adam_first_moment(state.opt_state))
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    return (images, masks, {k: float(v) for k, v in metrics.items()},
            from_jax_variables(c["name"], {"params": grads, "batch_stats": stats}))


def _step_grads(port, images, masks):
    got = make_train_step(port)(create_train_state(port), _nchw(images), _nchw(masks))
    return got, {n: p.grad.double().numpy() for n, p in port.module.named_parameters()}


def _running_stats(port):
    return {n: b.double().numpy() for n, b in port.module.state_dict().items() if "running" in n}


def _max_rel_dist(a, b):
    """Per tensor of ``b`` whose largest entry exceeds 1e-6, the largest
    |a - b| over that entry; and the names of the others."""
    d, tiny = {}, []
    for name, g in b.items():
        scale = np.abs(g).max()
        if scale <= 1e-6:
            tiny.append(name)
        else:
            d[name] = np.abs(a[name] - g).max() / scale
    return d, tiny


def check_train_step(c, conditioned, loss_rtol=1e-5):
    """One port step against one JAX step (float32) from the same variables
    and batch: each output key at the JAX spec's weight, loss and Dice at
    1e-5 relative; the running statistics after the step within 1e-5 of
    JAX's, and each clipped gradient within 1e-2 of its tensor's largest
    entry plus 1e-5.

    ``conditioned`` models are ill-conditioned in float32 at these sizes:
    train-mode BatchNorm over a few values a channel scales rounding up
    until a pre-activation within about 1e-5 of zero takes the other side
    of a ReLU, or a max pool the other pick, and every gradient that passes
    through it moves. attention_unet at depth 4 has one such ReLU in the
    port's step (att4's gate: 8.9e-6 in float64, -1.5e-5 in float32), which
    moves att4's gradients 2.7e-2 of their largest entry from float64 while
    JAX's step reads 2.0e-5; nested_unet reads 3.1e-2 (port) and 3.3e-2
    (JAX), u2net_tpu 8.5e-2 and 8.6e-2, u2netp 5.4e-2 and 5.2e-2, u2net
    1.7e-1 and 3.3e-1, at different tensors. So they are held in two parts:

    * the port's float32 step against its float64 copy replaying the float32
      step's branches (:class:`Branches`), which leaves rounding alone: every
      gradient within 1e-2 of its tensor's largest entry plus 1e-5 (read:
      2.4e-5 nested_unet to 2.7e-3 u2net), every running statistic within
      1e-4 relative and absolute (read: up to 2.9e-5, u2net), as it is of
      JAX's (a flip moves one value of a BatchNorm's many);
    * JAX's float32 step against the port's float64 copy taking its own
      branches: no further than three times the port's own float32 step (at
      least 1e-2 at the worst tensor, 1e-3 at the median), at the worst
      tensor and at the median one (read: at most 1.9 and 1.6 times). The
      first part holds the port's float32 path; a fault of the port's
      float64 model would put JAX far from it.

    Tensors whose float64 value is below 1e-6 (a bias before a BatchNorm,
    zero but for rounding) are held within 1e-5 on both sides. ``loss_rtol``
    (1e-5) bounds loss and Dice against JAX's; a model whose train-mode
    logits lie further than that from float64 on both sides states its own."""
    images, masks, metrics, ref = jax_step(c)
    port = port_model(c["name"], c["v"], **c["kw"])
    for k in c["want"]:
        assert port.loss_weight(k) == c["m"].loss_weight(k), k
    branches = Branches()
    with branches.record():
        got, g32 = _step_grads(port, images, masks)
    np.testing.assert_allclose(got["loss"].item(), metrics["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got["dice"].item(), metrics["dice"], rtol=loss_rtol, atol=1e-7)
    stats32 = _running_stats(port)
    if not conditioned:
        for name, buf in stats32.items():
            np.testing.assert_allclose(buf, ref[name].numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        for name, g in g32.items():
            g_ref = ref[name].numpy()
            np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-2 * np.abs(g_ref).max() + 1e-5,
                                       err_msg=name)
        return
    for name, buf in stats32.items():
        np.testing.assert_allclose(buf, ref[name].numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
    g32.update(stats32)

    def float64_step(replay):
        port64 = float64_copy(port_model(c["name"], c["v"], **c["kw"]))
        with float64_batch_norm(), branches.replay() if replay else contextlib.nullcontext():
            _, g64 = _step_grads(port64, images, masks)
        g64.update(_running_stats(port64))
        return g64

    g64 = float64_step(replay=True)
    for name, g in g64.items():
        tol = dict(rtol=1e-4, atol=1e-4) if name in stats32 else dict(
            rtol=0, atol=1e-2 * np.abs(g).max() + 1e-5)
        np.testing.assert_allclose(g32[name], g, err_msg=name, **tol)
    g64 = float64_step(replay=False)
    d_port, tiny = _max_rel_dist(g32, g64)
    d_jax, _ = _max_rel_dist({n: t.numpy() for n, t in ref.items()}, g64)
    for name in tiny:
        assert np.abs(g32[name]).max() <= 1e-5 and np.abs(ref[name].numpy()).max() <= 1e-5
    d_port, d_jax = list(d_port.values()), list(d_jax.values())
    assert max(d_jax) <= 3 * max(max(d_port), 1e-2), (max(d_jax), max(d_port))
    assert np.median(d_jax) <= 3 * max(np.median(d_port), 1e-3), (np.median(d_jax),
                                                                 np.median(d_port))


@pytest.mark.parametrize("key,conditioned", [("attention_unet_d4", True),
                                             ("nested_unet", True), ("resunet", False),
                                             ("u2net_tpu", True)])
def test_train_step_matches_jax(key, conditioned):
    check_train_step(member(key), conditioned)


def test_deep_supervision_loss_weights():
    """nested_unet's sides at the default 0.5, u2net_tpu's at 1 (the JAX
    registry's ``_U2NET_TPU_LOSS_WEIGHTS``)."""
    nested = create_model("nested_unet", device="cpu", deep_supervision=True)
    assert [nested.loss_weight(k) for k in ("main", "side1", "side2", "side3")] == [
        1.0, 0.5, 0.5, 0.5]
    tpu = create_model("u2net_tpu", device="cpu", widths=(16, 16, 16, 16))
    assert [tpu.loss_weight(f"side{i}") for i in range(1, 5)] == [1.0] * 4


# --- int8 --------------------------------------------------------------------------


INT8_SIZE = 32
INT8_GATED = {"attention_unet": 22, "nested_unet": 30, "resunet_narrow": 18,
              "u2net_tpu_narrow": 43}
# u2net_tpu's stride-4 stem and three stride-2 downs want 64px
INT8_SIZES = {"u2net_tpu_narrow": 64}


@functools.lru_cache(maxsize=None)
def calibrated(key):
    """Two seeded INT8_SIZE batches (INT8_SIZES where a model wants more) and
    JAX's ``quant`` collection from them (its ``calibrate_int8``, on the
    member's variables)."""
    c = member(key)
    size = INT8_SIZES.get(key, INT8_SIZE)
    rng = np.random.default_rng(INT8_SIZE)
    xs = [rng.standard_normal((1, size, size, 3)).astype(np.float32) * s
          for s in (1.0, 1.5)]
    vq = jax_calibrate_int8(c["m"], c["v"], [jnp.asarray(x) for x in xs])
    return xs, jax.tree_util.tree_map(np.asarray, vq["quant"])


@pytest.mark.parametrize("key", sorted(INT8_GATED))
def test_int8_calibration_matches_jax(key):
    """calibrate_int8 records the convs JAX's ``quant`` collection holds,
    with the same maxima to float rounding."""
    c = member(key)
    xs, quant = calibrated(key)
    port = port_model(c["name"], c["v"], **c["kw"])
    stats = calibrate_int8(port, [_nchw(x) for x in xs])
    want = quant_from_jax(c["name"], quant)
    assert len(stats) == len(want) == len(jax.tree_util.tree_leaves(quant)) == INT8_GATED[key]
    assert sorted(stats) == sorted(want)
    for k in want:
        np.testing.assert_allclose(stats[k].item(), want[k].item(), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("key", sorted(INT8_GATED))
def test_int8_every_gated_conv_matches_jax(key, monkeypatch):
    """The int8 model on JAX's statistics (float32 weights): every gated
    conv's output equals JAX's ``_QuantConv`` on the same input, weights and
    absmax, bit for bit (JAX op by op: jitted, XLA rounds some x / s_x near
    a half-way point the other way, and fuses the dequantisation), JAX given
    each conv's kernel size, padding and dilation (resunet's 1x1 skips,
    u2net_tpu's dilations 2, 4 and 8); the int8 path ran (logits away from
    the float model's). attention_unet's launch shapes are the ones
    ``chip_smoke.py`` expects (``int8_conv_plan.launch_shapes``), the others'
    those ``int8_conv_plan.traced_launch_shapes`` reads off the model.

    The whole int8 model is not held to JAX's int8 logits here: these random
    variables (BatchNorm off identity) put either framework's int8 logits
    about 0.24 rel L2 from its own float ones, and one activation that float
    rounding moves across a quantisation boundary then moves the rest (the
    port read 0.19 from JAX at 64px with every conv exact). How far int8
    moves the whole model from float is held against JAX's own distance
    below."""
    from unet_zoo_tpu_torch.probes.int8_conv_plan import launch_shapes, traced_launch_shapes

    c = member(key)
    xs, quant = calibrated(key)
    stats = quant_from_jax(c["name"], quant)
    port = port_model(c["name"], c["v"], **c["kw"])
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
    assert len(calls) == INT8_GATED[key]
    served = {m: n for n, m in port.module.named_modules()}
    for x, conv_m, y in calls:
        k = conv_m.weight.detach().numpy().transpose(2, 3, 1, 0)
        params = {"kernel": jnp.asarray(k)}
        if conv_m.bias is not None:
            params["bias"] = jnp.asarray(conv_m.bias.detach().numpy())
        want = _QuantConv(conv_m.out_channels, kernel_size=conv_m.kernel_size[0],
                          strides=conv_m.stride[0], padding=conv_m.padding[0],
                          kernel_dilation=conv_m.dilation[0],
                          use_bias=conv_m.bias is not None).apply(
            {"params": params}, jnp.asarray(_nhwc(x)), jnp.float32(stats[served[conv_m]]))
        np.testing.assert_array_equal(_nhwc(y), np.asarray(want), err_msg=served[conv_m])
    with torch.no_grad():
        floats = _nhwc(port_model(c["name"], c["v"], **c["kw"]).module(_nchw(xs[0]))["main"])
    assert _rel(got, floats) > 1e-3
    shapes = sorted((1, *x.shape[2:], x.shape[1], conv_m.out_channels, conv_m.stride[0],
                     conv_m.kernel_size[0], conv_m.padding[0], conv_m.dilation[0])
                    for x, conv_m, _ in calls)
    if key == "attention_unet":
        assert shapes == sorted((*r[:6], 3, 1, 1) for r in launch_shapes(key, INT8_SIZE, 1)
                                for _ in range(r[6]))
    rows = traced_launch_shapes(c["name"], xs[0].shape[1], 1, **c["kw"])
    assert shapes == sorted((*r[:6], *r[7:]) for r in rows for _ in range(r[6]))


def test_int8_attention_unet_strays_from_float_as_far_as_jax():
    """The port's seed-0 ``attention_unet`` at registry defaults (the weights
    ``chip_smoke.py`` serves int8), carried into JAX by its converter; each
    side calibrates on the same two seeded 64px images and serves a third,
    weights bf16-rounded as served. JAX's own int8 logits lie above JAX's
    0.10 rel L2 bar (``tests/test_quant.py``) from its float ones on these
    random weights (read: 0.126, masks 0.960), so the card cannot hold the
    port to that bar. The port's int8 lies no further than 1.25 times JAX's
    distance from its float (read: 0.135, masks 0.957), both keep JAX's 0.95
    mask bar, and the card's bar for this model is at least 1.5 times JAX's
    distance here: the distance grows with the image (0.100 at 32px), and the
    card serves 256px."""
    import chip_smoke
    from unet_zoo_tpu.utils.serving import cast_params_for_inference as jax_cast

    port = create_model("attention_unet", device="cpu", seed=0)
    model = jax_create_model("attention_unet")
    v = convert_state_dict("attention_unet", dict(port.module.state_dict()))
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((1, 64, 64, 3)).astype(np.float32) for _ in range(3)]
    vq = jax_calibrate_int8(model, v, [jnp.asarray(x) for x in xs[:2]])
    apply = jax.jit(lambda v_, x_: model.module.apply(v_, x_, train=False)["main"])
    jax_float, jax_int8 = (np.asarray(apply(jax_cast(w), jnp.asarray(xs[2])), np.float32)
                           for w in (v, vq))
    stats = calibrate_int8(port, [_nchw(x) for x in xs[:2]])
    port_float, port_int8 = (_nhwc(make_predictor(port, None, "logits", quant=q)(_nchw(xs[2])))
                             for q in (None, stats))
    agree = lambda a, b: float(np.mean((a > 0) == (b > 0)))
    jax_rel = _rel(jax_int8, jax_float)
    assert _rel(port_float, jax_float) <= 1e-3
    assert jax_rel > 0.10 and agree(jax_int8, jax_float) >= 0.95
    assert _rel(port_int8, port_float) <= 1.25 * jax_rel and agree(port_int8, port_float) >= 0.95
    rel_bar, mask_bar = chip_smoke.INT8_FLOAT_BARS["attention_unet"]
    assert rel_bar >= 1.5 * jax_rel and mask_bar == chip_smoke.INT8_FLOAT_AGREE == 0.95


def check_int8_strays_as_far_as_jax(c, stats, quant, x, apply=None, bar=1.25):
    """The port's int8 predictor (float32 weights, the README's recipe) lies
    no further from its float predictor than ``bar`` times JAX's int8 from
    JAX's float on the same variables, statistics and input (rel L2 of the
    main logits), and int8 moved both. Returns (port's, JAX's) distance."""
    port = port_model(c["name"], c["v"], **c["kw"])
    got = {q is None: _nhwc(make_predictor(port, None, "logits", cast_bf16=False,
                                           quant=q)(_nchw(x))) for q in (None, stats)}
    apply = apply or jax.jit(lambda v_, x_: c["m"].module.apply(v_, x_, train=False)["main"])
    jax_float = np.asarray(apply(c["v"], jnp.asarray(x)))
    jax_int8 = np.asarray(apply({**c["v"], "quant": quant}, jnp.asarray(x)))
    port_rel, jax_rel = _rel(got[False], got[True]), _rel(jax_int8, jax_float)
    assert _rel(got[True], jax_float) <= 1e-3
    assert 1e-4 < port_rel <= bar * jax_rel, (port_rel, jax_rel)
    return port_rel, jax_rel


@pytest.mark.parametrize("key", ["resunet_narrow", "u2net_tpu_narrow"])
def test_int8_strays_from_float_as_far_as_jax(key):
    """Narrow resunet (32px) and u2net_tpu (64px), whose 1x1 and dilated
    gated convs P2 now takes: served int8 end to end by ``make_predictor``
    on JAX's statistics, they move from float no further than 1.25 times
    JAX's own int8 does on the same variables."""
    xs, quant = calibrated(key)
    check_int8_strays_as_far_as_jax(member(key), quant_from_jax(member(key)["name"], quant),
                                    quant, xs[1])
