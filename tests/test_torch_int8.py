"""int8 serving in the port against the JAX package (CPU): the quantisation
arithmetic, the plain int8 conv, one gated ConvNormAct, calibration, whole
calibrated ``unet``/``unet_tpu`` models, and the P2/P1 probes' plain versions.

On the CPU the int8 conv wrapper runs its plain version (an exact float64
convolution); the CUDA kernel is held against that plain version bit for bit
by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card.
JAX's ``_QuantConv`` runs its s8 x s8 -> s32 ``lax.conv`` on XLA's CPU
backend, which computes it exactly (``tests/test_quant.py``).
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import _probe_gather as jax_p1
import _probe_int8_mosaic as jax_p2
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.nn.blocks import ConvNormAct as JaxConvNormAct
from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.nn import ConvNormAct, attach_int8
from unet_zoo_tpu_torch.ops import quant
from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2
from unet_zoo_tpu_torch.ops.kernels import row_gather as p1
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


def _jax_quant(kernel_hwio, x, absmax):
    """The JAX package's quantisation, ``unet_zoo_tpu/nn/blocks.py:85-93``."""
    kf = jnp.asarray(kernel_hwio).astype(jnp.float32)
    s_w = jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1, 2)), 1e-12) / 127.0
    wq = jnp.clip(jnp.round(kf / s_w), -127, 127).astype(jnp.int8)
    s_x = jnp.maximum(jnp.asarray(absmax).astype(jnp.float32), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(jnp.asarray(x).astype(jnp.float32) / s_x), -127, 127).astype(jnp.int8)
    return np.asarray(s_w), np.asarray(wq), np.asarray(s_x), np.asarray(xq)


# --- quantisation arithmetic ----------------------------------------------


@pytest.mark.parametrize("ci,co,bf16", [(3, 8, False), (16, 32, False), (48, 24, True)])
def test_weight_quantisation_matches_jax(ci, co, bf16):
    """s_w and wq bit for bit; bf16: the served weight already bf16-rounded;
    one output channel all zero (s_w from the 1e-12 floor)."""
    rng = np.random.default_rng(ci)
    k = rng.standard_normal((3, 3, ci, co)).astype(np.float32)
    k[..., 0] = 0.0
    if bf16:
        k = np.asarray(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
    s_w, wq, _, _ = _jax_quant(k, np.zeros((1, 1, 1, ci), np.float32), 1.0)
    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    if bf16:
        kt = kt.to(torch.bfloat16)
    got_s = quant.weight_scale(kt)
    got_q = quant.quantize_weight(kt, got_s)
    np.testing.assert_array_equal(got_s.numpy(), s_w)
    np.testing.assert_array_equal(got_q.numpy(), wq.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("absmax", [15.875, 2.0, 0.7373])
def test_activation_quantisation_matches_jax(absmax):
    """s_x and xq bit for bit. For absmax 15.875 (s_x = 1/8) and 2.0 the
    inputs lie on half-integer multiples of s_x, so round half to even is
    pinned (2.5 -> 2, 3.5 -> 4); values beyond absmax clip to +-127."""
    rng = np.random.default_rng(int(absmax * 1000))
    s_ref = np.float32(absmax) / np.float32(127.0)
    half = (rng.integers(-140, 140, (2, 6, 5, 7)) + 0.5).astype(np.float32)
    x = (half * s_ref).astype(np.float32) if absmax != 0.7373 else (
        rng.standard_normal((2, 6, 5, 7)).astype(np.float32) * absmax)
    _, _, s_x, xq = _jax_quant(np.zeros((3, 3, 7, 1), np.float32), x, absmax)
    got_s = quant.activation_scale(torch.tensor(absmax, dtype=torch.float32))
    got_q = quant.quantize_activation(_nchw(x), got_s)
    assert got_s.item() == float(s_x)
    np.testing.assert_array_equal(got_q.numpy().transpose(0, 2, 3, 1), xq)
    if absmax == 15.875:
        inner = xq[np.abs(xq) < 127]
        assert inner.size and not (inner % 2).any()       # every tie went to the even side
        assert np.abs(xq).max() == 127


# --- the plain int8 conv -----------------------------------------------------


@pytest.mark.parametrize("stride,ci,h,w,co", [
    (1, 3, 9, 11, 16),      # unet's first conv: Ci 3, K 27
    (1, 16, 8, 8, 24),
    (1, 48, 7, 5, 8),       # odd H and W
    (2, 16, 9, 9, 12),      # stride 2 on an odd size
    (2, 48, 10, 6, 32),
    (2, 3, 5, 8, 4),
])
def test_plain_int8_conv_matches_jax_exactly(stride, ci, h, w, co):
    """The plain int8 conv equals JAX's s8 x s8 -> s32 ``lax.conv`` exactly,
    with the extremes +-127 everywhere in one image; the packed-weight form
    (``int8_conv3x3_reference``) gives the same sums."""
    rng = np.random.default_rng(stride * 100 + ci + h)
    x = rng.integers(-127, 128, (2, h, w, ci)).astype(np.int8)
    x[1] = 127
    k = rng.integers(-127, 128, (3, 3, ci, co)).astype(np.int8)
    k[..., 0] = -127
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    wq = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    got = quant.int8_conv2d_exact(torch.from_numpy(x).permute(0, 3, 1, 2), wq, stride, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    wp = p2.pack_conv_weight(wq)
    assert wp.shape == (co, -(-9 * ci // 64) * 64) and not wp[:, 9 * ci:].any()
    ones = torch.ones(co)
    acc = p2.int8_conv3x3_reference(torch.from_numpy(x).float(), torch.tensor(1.0), wp, ones,
                                    None, stride, torch.float32)
    np.testing.assert_array_equal(acc.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("ci", [3, 20, 64, 128, 384])
def test_pack_conv_weight_round_trip(ci):
    """pack_conv_weight's K order: (ky, kx, ci), or for Ci a multiple of 128
    (channel block, ky, kx, ci in the block), one tap of one block per
    128-byte K stage of the kernel; unpack_conv_weight inverts it."""
    rng = np.random.default_rng(ci)
    w = torch.from_numpy(rng.integers(-127, 128, (5, ci, 3, 3)).astype(np.int8))
    wp = p2.pack_conv_weight(w)
    assert wp.shape == (5, -(-9 * ci // p2.K_ALIGN) * p2.K_ALIGN) and not wp[:, 9 * ci:].any()
    assert torch.equal(p2.unpack_conv_weight(wp, ci), w)
    for kt in range(9 * ci // p2.K_STAGE if ci % p2.K_STAGE == 0 else 0):
        block, tap = divmod(kt, 9)
        assert torch.equal(wp[:, kt * p2.K_STAGE:(kt + 1) * p2.K_STAGE],
                           w[:, block * p2.K_STAGE:(block + 1) * p2.K_STAGE, tap // 3, tap % 3])


# The kernel's plain version takes the float activation and s_x, as the
# kernel does (it quantises x as it loads it). s_x = 2^-3 (absmax 15.875)
# puts (n + 1/2) s_x exactly on half-way points of x / s_x, which round half
# to even; 3.7 is a scale with no such points. Values beyond 127 s_x clamp.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("absmax", [15.875, 3.7])
def test_int8_conv_reference_matches_jax_quant_conv(dtype, stride, absmax):
    """``int8_conv3x3_reference(x, s_x, ...)`` against JAX's ``_QuantConv``
    (``unet_zoo_tpu/nn/blocks.py:82-101``, applied op by op) on the same
    float x, kernel, bias and absmax: equal in every bit."""
    from unet_zoo_tpu.nn.blocks import _QuantConv

    ci, co, h, w = 16, 24, 9, 7
    rng = np.random.default_rng(int(absmax * 10) + stride)
    s_x = np.float32(absmax) / np.float32(127.0)
    x = (rng.standard_normal((2, h, w, ci)) * absmax / 2).astype(np.float32)
    spots = rng.random(x.shape)
    x = np.where(spots < 0.2, (rng.integers(-127, 127, x.shape) + 0.5) * s_x, x)
    x = np.where(spots > 0.95, rng.choice([-1.0, 1.0], x.shape) * 200 * s_x, x)
    x = x.astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if dtype == torch.bfloat16:
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    k = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.1).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    if absmax == 15.875:
        assert (np.asarray(xj.astype(jnp.float32)) / s_x % 1 == 0.5).mean() > 0.1
    assert (np.abs(x) > 127.5 * s_x).mean() > 0.02
    want = np.asarray(_QuantConv(co, strides=stride, dtype=jdt).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)}}, xj,
        jnp.float32(absmax)).astype(jnp.float32))

    kt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    s_w = quant.weight_scale(kt)
    st = quant.activation_scale(torch.tensor(absmax, dtype=torch.float32))
    wp = p2.pack_conv_weight(quant.quantize_weight(kt, s_w))
    xt = torch.from_numpy(x).to(dtype)
    got = p2.int8_conv3x3_reference(xt, st, wp, st * s_w, torch.from_numpy(bias), stride, dtype)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    # through the wrapper on the CPU: the plain version
    torch.testing.assert_close(p2.int8_conv3x3(xt, st, wp, st * s_w, torch.from_numpy(bias),
                                               stride, dtype), got, rtol=0, atol=0)


def _fma32(a, b, c):
    """rn(a * b + c) in float32, one rounding (a float32 product is exact in
    float64, and so is its sum with c at the magnitudes used here)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def test_kernel_quantisation_rule_is_the_true_division():
    """The conv kernel's producer (``csrc/int8_gemm.cu::quick``/``exact``/``NEAR``)
    rounds the exact product x * rn(1 / s_x) by fma'ing it onto 1.5 2^23,
    clamps, and takes the true quotient only where the product lies within
    2^-14 of a half-integer; in float32 arithmetic that rule gives
    clip(round(x / s_x)) exactly, on random scales and values, exact
    half-way points, zeros, clamped and huge values."""
    rng = np.random.default_rng(11)
    n = 1 << 20
    s = (np.exp(rng.uniform(-9, 3, n)) / 127).astype(np.float32)
    x = (rng.standard_normal(n) * rng.choice([1, 50, 300], n) * s).astype(np.float32)
    half = ((rng.integers(-200, 200, n) + 0.5) * s).astype(np.float32)
    x = np.where(rng.random(n) < 0.3, half, x)
    x[:1000] = 0
    x[1000:2000] = (rng.standard_normal(1000) * 1e30).astype(np.float32)
    rounder = np.float32(1.5 * 2 ** 23)
    r = np.float32(1) / s
    with np.errstate(over="ignore", invalid="ignore"):
        q = np.float32(x / s)                                   # the true quotient
        z = _fma32(x, r, np.full(n, rounder))
        d = _fma32(x, r, -(z - rounder))
    near = np.abs(d) >= np.float32(0.5 - 2.0 ** -14)
    z = np.clip(z, rounder - 127, rounder + 127).astype(np.float32)
    assert 0 < near.mean() < 0.5
    quick = (z.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    want = np.clip(np.rint(q), -127, 127).astype(np.int8)
    got = np.where(near, want, quick)       # exact(): the true quotient where near
    np.testing.assert_array_equal(got, want)


# --- the conv kernel's launch plan (a plain function the CPU reaches) ---------


def _served_conv_shapes():
    import chip_smoke

    return [(name, row) for name in ("unet_tpu", "unet", "attention_unet", "transatt_unet",
                                     "unet_transformer")
            for row in chip_smoke.int8_launch_shapes(name)]


@pytest.mark.parametrize("name,row", _served_conv_shapes())
def test_conv_plan_fills_the_card(name, row):
    """Every int8 conv launch shape of unet_tpu, unet, attention_unet,
    transatt_unet and unet_transformer at B=8/256px gets at least one block
    per SM (132), or as many as its K has stages; no split is left without K;
    the tile is one the kernel takes."""
    b, h, w, ci, co, stride, _ = row
    m = b * p2.conv_out_size(h, stride) * p2.conv_out_size(w, stride)
    kpad = -(-9 * ci // p2.K_ALIGN) * p2.K_ALIGN
    bm, bn, splits = p2.conv_plan(m, co, kpad)
    assert bm == p2.BM and bn in p2.TILE_N
    stages = -(-kpad // p2.K_STAGE)
    tiles = -(-m // bm) * -(-co // bn)
    assert tiles * splits >= min(p2.SMS, tiles * stages)
    assert 1 <= splits <= stages
    bounds = [z * stages // splits for z in range(splits + 1)]   # the kernel's K ranges
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("name,row", _served_conv_shapes())
def test_conv_plan_probe_times_the_plan(name, row):
    """The plan probe's launches at a served shape include conv_plan's own,
    which has the least modelled cost of them."""
    from unet_zoo_tpu_torch.probes import int8_conv_plan

    b, h, w, ci, co, stride, _ = row
    m = b * p2.conv_out_size(h, stride) * p2.conv_out_size(w, stride)
    kpad = -(-9 * ci // p2.K_ALIGN) * p2.K_ALIGN
    bm, bn, splits = p2.conv_plan(m, co, kpad)
    timed = int8_conv_plan.candidates(m, co, kpad)
    assert (bn, splits) in timed
    assert all(p2.plan_cost(m, co, kpad, bn, splits) <= p2.plan_cost(m, co, kpad, *c)
               for c in timed)


@pytest.mark.parametrize("m,n,kbytes", [(512, 512, 4608), (1, 1, 64), (100, 130, 192),
                                        (524288, 64, 64), (70, 600, 9216)])
def test_conv_plan_edges(m, n, kbytes):
    """Odd shapes: tiny grids take every stage a split; N between tile
    widths; a split never outnumbers K's stages."""
    bm, bn, splits = p2.conv_plan(m, n, kbytes)
    stages = -(-kbytes // p2.K_STAGE)
    tiles = -(-m // bm) * -(-n // bn)
    assert bn in p2.TILE_N and 1 <= splits <= stages
    assert tiles * splits >= min(p2.SMS, tiles * stages)
    assert bn == p2.TILE_N[0] or n > bn // 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantisation_matches_jax(dtype):
    """acc * (s_x * s_w) + bias, rounded once to the compute type, against
    JAX's epilogue (``nn/blocks.py:96-100``) on the same int32 sums."""
    rng = np.random.default_rng(7)
    acc = rng.integers(-2 ** 27, 2 ** 27, (2, 5, 5, 16)).astype(np.int32)
    s_w = (rng.random(16) * 1e-2 + 1e-4).astype(np.float32)
    s_x = np.float32(0.0371)
    bias = rng.standard_normal(16).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray((jnp.asarray(acc).astype(jnp.float32) * (s_x * jnp.asarray(s_w))
                       + jnp.asarray(bias)).astype(jdt).astype(jnp.float32))
    scale = torch.tensor(s_x) * torch.from_numpy(s_w)
    got = quant.dequantize(torch.from_numpy(acc), scale, torch.from_numpy(bias), dtype,
                           channel_dim=-1)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -23 if dtype ==
                               torch.float32 else 2 ** -8, atol=0)


# --- one gated conv block ----------------------------------------------------


def _perturb_bn(rng, params, stats):
    """BN statistics and affine moved off identity, in JAX variables."""
    if "mean" in stats:
        stats["mean"] = rng.standard_normal(stats["mean"].shape).astype(np.float32) * 0.1
        stats["var"] = (rng.random(stats["var"].shape) + 0.5).astype(np.float32)
        params["scale"] = (rng.random(params["scale"].shape) + 0.5).astype(np.float32)
        params["bias"] = rng.standard_normal(params["bias"].shape).astype(np.float32) * 0.1
        return
    for k in stats:
        _perturb_bn(rng, params[k], stats[k])


@pytest.mark.parametrize("stride,ci,co", [(1, 8, 32), (2, 16, 24), (1, 3, 16)])
def test_conv_norm_act_int8_matches_jax(stride, ci, co):
    """A gated ConvNormAct with the same weights and calibrated absmax: the
    port's int8 path against JAX's ``_QuantConv`` path (f32; the integer
    sums agree exactly, the float epilogue and BatchNorm to rounding), and
    far from the float path (the int8 path really ran)."""
    rng = np.random.default_rng(stride + ci)
    x = rng.standard_normal((2, 12, 12, ci)).astype(np.float32)
    m = JaxConvNormAct(co, strides=stride)
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        m.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    v["params"]["Conv_0"]["bias"] = rng.standard_normal(co).astype(np.float32) * 0.1
    _perturb_bn(rng, v["params"], v["batch_stats"])
    y_float, st = m.apply(v, jnp.asarray(x), train=False, mutable=["quant_stats"])
    want = np.asarray(m.apply(dict(v, quant=st["quant_stats"]), jnp.asarray(x), train=False))

    blk = ConvNormAct(ci, co, stride)
    sd = {"conv.weight": torch.from_numpy(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)
                                          .copy()),
          "conv.bias": torch.from_numpy(v["params"]["Conv_0"]["bias"])}
    for ours, theirs in (("weight", "scale"), ("bias", "bias")):
        sd[f"bn.{ours}"] = torch.from_numpy(np.asarray(v["params"]["BatchNorm_0"][theirs]))
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        sd[f"bn.{ours}"] = torch.from_numpy(np.asarray(v["batch_stats"]["BatchNorm_0"][theirs]))
    sd["bn.num_batches_tracked"] = torch.tensor(0)
    blk.load_state_dict(sd)
    blk.eval()
    attach_int8(blk, {"conv": torch.tensor(float(st["quant_stats"]["in_absmax"]))})
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _rel(got, y_float) > 1e-3


def test_int8_conv_dispatch_on_the_cpu(monkeypatch):
    """On the CPU use_kernels True reaches the kernel wrapper (which runs
    the plain version for a CPU tensor), None and False the plain version
    directly; all three agree."""
    rng = np.random.default_rng(3)
    blk = ConvNormAct(8, 16).eval()
    attach_int8(blk, {"conv": torch.tensor(2.5)})
    x = _nchw(rng.standard_normal((1, 6, 6, 8)).astype(np.float32))
    calls = {"kernel": 0}
    kernel = p2.int8_conv3x3

    def counting(*a):
        calls["kernel"] += 1
        return kernel(*a)

    monkeypatch.setattr(p2, "int8_conv3x3", counting)
    outs = []
    for use in (True, None, False):
        blk.use_kernels = use
        with torch.no_grad():
            outs.append(blk(x))
    assert calls["kernel"] == 1
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)


# --- whole models ------------------------------------------------------------


def _jax_model(name, x, seed=0, **kw):
    m = jax_create_model(name, **kw)
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        m.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]))))
    _perturb_bn(np.random.default_rng(seed + 1), v["params"], v["batch_stats"])
    return m, v


def _port_model(name, v, **kw):
    m = create_model(name, device="cpu", **kw)
    m.module.load_state_dict(from_jax_variables(name, v), strict=True)
    return m


# 64px: at 32px unet's bottleneck is 2x2, where one activation that float
# rounding moves across a quantisation boundary moves every output (JAX's own
# int8 logits then differ by 3.5e-2 between a jitted and a constant-folded
# run); at 64px both JAX runs and the port agree to 3e-7.
MODELS = {"unet": dict(size=64, kw={}, gated=18),
          "unet_tpu": dict(size=64, kw={"widths": (16, 32, 32, 32)}, gated=17)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def calibrated(request):
    """JAX model and variables (BN off identity), two calibration batches,
    JAX's calibrated variables and its float and int8 logits (jitted)."""
    name = request.param
    cfg = MODELS[name]
    rng = np.random.default_rng(11)
    xs = [rng.standard_normal((2, cfg["size"], cfg["size"], 3)).astype(np.float32)
          for _ in range(2)]
    xs[1] *= 1.5     # the second batch sets some maxima
    m, v = _jax_model(name, xs[0], **cfg["kw"])
    vq = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        jax_calibrate_int8(m, v, [jnp.asarray(x) for x in xs])))
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
    x = xs[0]
    return dict(name=name, cfg=cfg, m=m, v=v, vq=vq, xs=xs, x=x, apply=apply,
                y_float=np.asarray(apply(v, jnp.asarray(x))),
                y_int8=np.asarray(apply(vq, jnp.asarray(x))))


def test_calibration_matches_jax(calibrated):
    """calibrate_int8's statistics against JAX's ``quant`` collection, entry
    by entry (the same gated convs; the maxima agree to the float forwards'
    rounding, the first conv's exactly: it sees the input)."""
    c = calibrated
    port = _port_model(c["name"], c["v"], **c["cfg"]["kw"])
    stats = calibrate_int8(port, [_nchw(x) for x in c["xs"]])
    want = quant_from_jax(c["name"], c["vq"]["quant"])
    assert len(stats) == len(want) == c["cfg"]["gated"]
    assert sorted(stats) == sorted(want)
    for k in want:
        assert stats[k].dtype == torch.float32 and stats[k].dim() == 0
        np.testing.assert_allclose(stats[k].item(), want[k].item(), rtol=1e-5, err_msg=k)
    first = "down_convolution_1.conv.conv_op.0" if c["name"] == "unet" else "enc0.conv_op.0"
    if c["name"] == "unet":
        assert stats[first].item() == float(np.abs(np.stack(c["xs"])).max())


def test_calibration_leaves_the_model_alone(calibrated):
    c = calibrated
    port = _port_model(c["name"], c["v"], **c["cfg"]["kw"])
    before = {k: t.clone() for k, t in port.module.state_dict().items()}
    calibrate_int8(port, [_nchw(c["x"])])
    for k, t in port.module.state_dict().items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)
    assert not any(hasattr(m, "int8") for m in port.module.modules())


# Whole int8 models against JAX's, on the same statistics. Each gated conv
# agrees exactly with JAX's on the same operands (the block tests above), but
# the float compute between them differs in the last bits, and now and then
# that moves an activation across a quantisation boundary. Random-weight unet
# passes one such move on to every logit: over 8 input draws the port read
# 1.4e-7 to 2.6e-4 without a move and up to 5.7e-2 (masks 0.980) with one,
# unet_tpu up to 1.9e-2 (0.997). So whole models are held to the int8 bars,
# rel L2 < 0.10 and masks >= 0.97, and exactness to the blocks.
INT8_REL_L2, INT8_AGREE = 0.10, 0.97


@pytest.mark.parametrize("cast_bf16", [False, True])
def test_int8_logits_match_jax(calibrated, cast_bf16):
    """The calibrated int8 model (JAX's statistics carried over) against JAX's
    int8 forward, float32 or bf16-rounded weights (JAX's
    ``cast_params_for_inference``; the statistics are not cast), within
    INT8_REL_L2 and INT8_AGREE; on both sides the int8 model stays within
    JAX's own bars of its float one (``tests/test_quant.py``: rel L2 < 0.10,
    masks > 0.95), and the port's float model matches JAX's at 2e-3."""
    from unet_zoo_tpu.utils.serving import cast_params_for_inference as jax_cast

    c = calibrated
    port = _port_model(c["name"], c["v"], **c["cfg"]["kw"])
    stats = quant_from_jax(c["name"], c["vq"]["quant"])
    got = _nhwc(make_predictor(port, None, "logits", cast_bf16=cast_bf16, quant=stats)(
        _nchw(c["x"])))
    floats = _nhwc(make_predictor(port, None, "logits", cast_bf16=cast_bf16)(_nchw(c["x"])))
    want, want_float = c["y_int8"], c["y_float"]
    if cast_bf16:
        want, want_float = (np.asarray(c["apply"](jax_cast(v), jnp.asarray(c["x"])))
                            for v in (c["vq"], c["v"]))
    assert _rel(got, want) < INT8_REL_L2
    assert float(np.mean((got > 0) == (want > 0))) >= INT8_AGREE
    np.testing.assert_allclose(floats, want_float, rtol=2e-3, atol=2e-3)
    for q, f in ((got, floats), (want, want_float)):
        gap, agree = _rel(q, f), float(np.mean((q > 0) == (f > 0)))
        assert 1e-3 < gap < 0.10 and agree > 0.95, (gap, agree)


def test_int8_with_own_calibration(calibrated):
    """The port's own recipe end to end (calibrate_int8 -> make_predictor,
    bf16-rounded weights) against JAX's own (its calibrate_int8, cast
    variables). The two calibrations agree to float rounding
    (test_calibration_matches_jax), which moves more activations across
    quantisation boundaries (read: rel L2 5.7e-2 for unet, below 1e-2 for
    unet_tpu); held to INT8_REL_L2 and INT8_AGREE. Masks through flip TTA
    come out uint8."""
    from unet_zoo_tpu.utils.serving import cast_params_for_inference as jax_cast

    c = calibrated
    port = _port_model(c["name"], c["v"], **c["cfg"]["kw"])
    stats = calibrate_int8(port, [_nchw(x) for x in c["xs"]])
    got = _nhwc(make_predictor(port, None, "logits", quant=stats)(_nchw(c["x"])))
    want = np.asarray(c["apply"](jax_cast(c["vq"]), jnp.asarray(c["x"])))
    assert _rel(got, want) < INT8_REL_L2
    assert float(np.mean((got > 0) == (want > 0))) >= INT8_AGREE
    mask = make_predictor(port, None, "mask", quant=stats, tta=True)(_nchw(c["x"]))
    assert mask.dtype == torch.uint8 and tuple(mask.shape) == (2, 1, *c["x"].shape[1:3])


def test_train_mode_ignores_quant(calibrated):
    """Training with int8 weights attached is the float path exactly."""
    c = calibrated
    outs = []
    for attach in (False, True):
        port = _port_model(c["name"], c["v"], **c["cfg"]["kw"])
        if attach:
            attach_int8(port.module, quant_from_jax(c["name"], c["vq"]["quant"]))
        port.module.train()
        outs.append(port.module(_nchw(c["x"]))["main"].detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)


@pytest.mark.parametrize("calibrated", ["unet"], indirect=True)
def test_k1_ignores_quant_as_in_jax(calibrated, monkeypatch):
    """unet with use_kernels=True (K1's plain version on the CPU) against JAX
    with use_pallas=True (the Pallas decoder in interpret mode): both fused
    decoder stages read float weights, so only the 10 encoder and bottleneck
    convs run int8."""
    c = calibrated
    want = np.asarray(c["m"].module.clone(use_pallas=True).apply(
        c["vq"], jnp.asarray(c["x"]), train=False)["main"])
    calls = {"n": 0}
    kernel = p2.int8_conv3x3

    def counting(*a):
        calls["n"] += 1
        return kernel(*a)

    monkeypatch.setattr(p2, "int8_conv3x3", counting)
    port = _port_model("unet", c["v"], use_kernels=True)
    got = _nhwc(make_predictor(port, None, "logits", cast_bf16=False,
                               quant=quant_from_jax("unet", c["vq"]["quant"]))(_nchw(c["x"])))
    assert calls["n"] == 10
    assert _rel(got, want) < INT8_REL_L2
    assert float(np.mean((got > 0) == (want > 0))) >= INT8_AGREE
    assert _rel(want, c["y_int8"]) > 1e-3      # JAX's fused decoder is not all int8 either


def test_calibrate_raises_as_jax():
    x = torch.randn(1, 3, 32, 32)
    m = create_model("unet", device="cpu")
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_int8(m, [])
    mm = create_model("mmunet", device="cpu", base_channels=16)
    with pytest.raises(ValueError, match="no quantizable convs"):
        calibrate_int8(mm, [x])


def test_attach_int8_rejects_what_is_not_a_gated_conv():
    m = create_model("unet_tpu", device="cpu", widths=(16, 32, 32, 32))
    with pytest.raises(ValueError, match="not an int8-gated conv"):
        attach_int8(m.module, {"enc0.conv_op.1": torch.tensor(1.0)})
    with pytest.raises(ValueError, match="3x3 convs"):
        attach_int8(m.module, {"stem": torch.tensor(1.0)})


# --- the probes' plain versions ----------------------------------------------


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The probe's ``pl.pallas_call`` in interpret mode (a CPU run of the
    TPU kernel's body); restored after the test."""
    monkeypatch.setattr(jax_p2.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("m,n,k,bk", [(256, 128, 128, 0), (128, 256, 256, 128)])
def test_plain_int8_gemm_matches_probe(pallas_interpret, m, n, k, bk):
    """s8 x s8 -> s32: exactly the probe's Pallas kernel (full-K and
    K-tiled) run in interpret mode."""
    rng = np.random.default_rng(m + k)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(jax_p2.make_matmul(m, n, k, jnp.int8, jnp.int32, 128, 128, bk)(
        jnp.asarray(a), jnp.asarray(b)))
    got = p2.matmul(torch.from_numpy(a), torch.from_numpy(b.T.copy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bk", [0, 128])
def test_plain_bf16_gemm_matches_probe(pallas_interpret, bk):
    """bf16 x bf16 -> f32 against the probe's kernel in interpret mode: the
    products are exact in f32, the sums taken in another order (1e-5 of the
    output rms)."""
    rng = np.random.default_rng(bk)
    a = jnp.asarray(rng.standard_normal((128, 256)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((256, 128)), jnp.bfloat16)
    want = np.asarray(jax_p2.make_matmul(128, 128, 256, jnp.bfloat16, jnp.float32, 128, 128,
                                         bk)(a, b))
    ta = torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    tb = torch.from_numpy(np.array(b.astype(jnp.float32)).T.copy()).to(torch.bfloat16)
    got = p2.matmul(ta, tb).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.sqrt(np.mean(want ** 2))


@pytest.mark.parametrize("n", [jax_p1.N, 100])
def test_plain_row_gather_matches_probe(n):
    """P1's plain version against the probe's own reference
    (``_probe_gather.py:67``) and its ``take`` kernel in interpret mode."""
    rng = np.random.default_rng(n)
    tab = rng.standard_normal((jax_p1.ROWS, jax_p1.C)).astype(np.float32)
    idx = rng.integers(0, jax_p1.ROWS, size=(1, n)).astype(np.int32)
    ref = np.asarray(tab)[np.asarray(idx)[0]]
    got = p1.row_gather(torch.from_numpy(tab), torch.from_numpy(idx[0]))
    np.testing.assert_array_equal(got.numpy(), ref)
    if n == jax_p1.N:
        vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
        take = pl.pallas_call(
            jax_p1.k_take, grid=(1,),
            in_specs=[vmem((jax_p1.ROWS, jax_p1.C), lambda i: (0, 0)),
                      vmem((1, n), lambda i: (0, 0))],
            out_specs=vmem((n, jax_p1.C), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((n, jax_p1.C), jnp.float32), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(take(jnp.asarray(tab),
                                                                   jnp.asarray(idx))))


def test_probe_clis_run_the_plain_versions(capsys):
    from unet_zoo_tpu_torch.probes import gather, int8_matmul

    int8_matmul.main(["--m", "128", "--n", "64", "--k", "96", "--steps", "1", "--device", "cpu"])
    gather.main(["kernel", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "s8xs8->s32" in out and "int8 vs bf16 ratio" in out and "max_err=0.00e+00" in out
    with pytest.raises(SystemExit):
        int8_matmul.main(["--bm", "512", "--device", "cpu"])
    from unet_zoo_tpu_torch.probes import gated_step, int8_conv_plan, medt_paths, mkblock_grids

    for card_only in (int8_conv_plan, medt_paths, gated_step, mkblock_grids):   # they time or compare on the card
        with pytest.raises(SystemExit, match="CUDA is not available"):
            card_only.main([])
