"""The MedT family in the port against the JAX package (CPU).

K6 (``fused_axial_attention``): on the CPU the port's wrapper runs its
plain version, held here against the JAX Pallas kernel in interpret mode
and against the JAX fold, with the traps the port has to get right: the kr
term reads the transposed embedding (a), the relative table keeps the
ks - 1 offset on axes shorter than the kernel size (b), and the channel
orders of qkv, ``bn_similarity`` and ``bn_output`` (c). The CUDA kernel
itself is held against the plain version by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card.
Modules and the five registry names (32px, f32) run against the JAX eval
forward, whose CPU path (the XLA one) is the oracle.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.models.medt_net import AxialAttention as JaxAxialAttention
from unet_zoo_tpu.models.medt_net import _relative_index as jax_relative_index
from unet_zoo_tpu.ops.pallas import axial_attention as jax_k6
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import make_predictor as jax_make_predictor
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.models.medt_net import AxialAttention
from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6
from unet_zoo_tpu_torch.utils import convert as port_convert
from unet_zoo_tpu_torch.utils.convert import from_jax_variables
from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference, make_predictor

torch.set_num_threads(1)

CL = torch.channels_last
NAMES = ["axialunet", "gated", "medt", "logo", "medt_logo"]
SIZE = 32


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _perturb(rng, params, stats):
    """Move every BatchNorm's statistics and affine off identity and every
    gate off its initial value."""
    for gate in ("f_qr", "f_kr", "f_sv", "f_sve"):
        if gate in params:
            params[gate] = jnp.asarray(rng.uniform(0.5, 1.5), jnp.float32)
    if "mean" in stats:
        stats["mean"] = jnp.asarray(rng.standard_normal(stats["mean"].shape) * 0.1, jnp.float32)
        stats["var"] = jnp.asarray(rng.random(stats["var"].shape) + 0.5, jnp.float32)
        params["scale"] = jnp.asarray(rng.random(params["scale"].shape) + 0.5, jnp.float32)
        params["bias"] = jnp.asarray(rng.standard_normal(params["bias"].shape) * 0.1,
                                     jnp.float32)
        return
    for k in stats:
        _perturb(rng, params[k], stats[k])


# --- K6 --------------------------------------------------------------------


def _k6_case(rng, b, h, w, g, gp, ks, mode):
    """Port operands of one axis pass, and the JAX kernel's [3, g] shift and
    [2, g, gp] output shift (whose two rows the port sums)."""
    wopos = mode == "wopos"
    qkv = rng.standard_normal((b, 2 * g * gp, h, w)).astype(np.float32)
    relative = None if wopos else (rng.standard_normal((2 * gp, 2 * ks - 1))
                                   / np.sqrt(gp)).astype(np.float32)
    sim_scale = rng.uniform(0.5, 1.5, (3, g)).astype(np.float32)
    out_scale = rng.uniform(0.5, 1.5, (2, g, gp)).astype(np.float32)
    if wopos:
        sim_scale[1:] = 0.0
        out_scale[1] = 0.0
    shifts = (rng.standard_normal((2, g, gp)) * 0.1).astype(np.float32)
    sim_shift = rng.standard_normal((3, g)).astype(np.float32)
    return qkv, relative, sim_scale, out_scale, shifts, sim_shift


def _rows_np(a, width_axis):
    """[B, C, H, W] -> [B*R, L, C] (numpy)."""
    x = a.transpose(0, 2, 3, 1)
    if not width_axis:
        x = x.transpose(0, 2, 1, 3)
    return x.reshape(-1, x.shape[2], x.shape[3])


def _port_k6(qkv, relative, sim_scale, out_scale, shifts, ks, width_axis):
    t = lambda a: None if a is None else torch.from_numpy(a)
    return k6.fused_axial_attention(_nchw(qkv.transpose(0, 2, 3, 1)), t(relative),
                                    t(sim_scale), t(out_scale), t(shifts.sum(0)), ks,
                                    width_axis)


@pytest.mark.parametrize("mode,width_axis,h,w,gp,ks", [
    ("base", True, 6, 8, 4, 8),       # L == ks
    ("gated", False, 7, 5, 4, 9),     # L < ks: the table keeps the ks - 1 offset
    ("base", False, 9, 3, 2, 12),     # L < ks, gp = 2
    ("wopos", True, 4, 6, 4, 6),
    ("wopos", False, 5, 4, 8, 5),
])
def test_reference_matches_jax_kernel(mode, width_axis, h, w, gp, ks):
    """float32 on both sides, the JAX kernel in interpret mode: 1e-4. The
    JAX similarity shift is random: it must drop out."""
    g, b = 2, 1
    qkv, relative, sim_scale, out_scale, shifts, sim_shift = _k6_case(
        np.random.default_rng(0), b, h, w, g, gp, ks, mode)
    length = w if width_axis else h
    x = _rows_np(qkv, width_axis).reshape(-1, length, g, 2 * gp)
    c = gp // 2
    q, k, v = (jnp.asarray(x[..., :c]), jnp.asarray(x[..., c:gp]), jnp.asarray(x[..., gp:]))
    embs = (None, None, None)
    if relative is not None:
        emb = relative[:, jax_relative_index(ks)].reshape(2 * gp, ks, ks)[:, :length, :length]
        embs = (jnp.asarray(emb[:c]), jnp.asarray(emb[c:gp]), jnp.asarray(emb[gp:]))
    ref = jax_k6.fused_axial_attention(q, k, v, *embs, jnp.asarray(sim_scale),
                                       jnp.asarray(sim_shift), jnp.asarray(out_scale),
                                       jnp.asarray(shifts), wopos=mode == "wopos",
                                       interpret=True)
    ref = np.asarray(ref).reshape(b, -1, length, g * gp)
    if not width_axis:
        ref = ref.transpose(0, 2, 1, 3)
    got = _port_k6(qkv, relative, sim_scale, out_scale, shifts, ks, width_axis)
    assert got.shape == (b, g * gp, h, w) and got.is_contiguous(memory_format=CL)
    np.testing.assert_allclose(_nhwc(got), ref, rtol=0, atol=1e-4)


def test_kr_term_reads_transposed_embedding():
    """Trap (a): with only the kr term on, sim[i, j] = a_kr Σ_c k[j,c] ·
    relative[c_k, j - i + ks - 1], written out here with loops. Reading
    the embedding untransposed (i - j) gives another output."""
    g, gp, ks, h = 1, 4, 7, 5
    c = gp // 2
    qkv, relative, sim_scale, out_scale, shifts, _ = _k6_case(
        np.random.default_rng(1), 1, h, 1, g, gp, ks, "base")
    sim_scale[:2] = 0.0
    out_scale[1] = 0.0
    got = _nhwc(_port_k6(qkv, relative, sim_scale, out_scale, shifts, ks, False))[0, :, 0]
    x = qkv[0, :, :, 0].T                                   # [L, 2gp]
    k, v = x[:, c:gp], x[:, gp:]

    def expected(sign):
        sim = np.array([[sim_scale[2, 0] * sum(k[j, cc] * relative[c + cc, sign * (j - i) + ks - 1]
                                               for cc in range(c)) for j in range(h)]
                        for i in range(h)])
        sim = np.exp(sim - sim.max(1, keepdims=True))
        sim /= sim.sum(1, keepdims=True)
        return out_scale[0, 0] * (sim @ v) + shifts.sum(0)[0]

    np.testing.assert_allclose(got, expected(1), rtol=0, atol=1e-5)
    assert np.abs(got - expected(-1)).max() > 1e-2


@pytest.mark.parametrize("ks,length", [(9, 9), (9, 5), (16, 1)])
def test_relative_embeddings_match_jax(ks, length):
    """Trap (b): emb[c, a, b] = relative[c, a - b + ks - 1], cut to L, as the
    JAX module indexes it; an axis longer than ks raises."""
    rel = np.random.default_rng(2).standard_normal((4, 2 * ks - 1)).astype(np.float32)
    want = rel[:, jax_relative_index(ks)].reshape(4, ks, ks)[:, :length, :length]
    got = k6.relative_embeddings(torch.from_numpy(rel), ks, length).numpy()
    np.testing.assert_array_equal(got, want)
    a, b = np.meshgrid(np.arange(length), np.arange(length), indexing="ij")
    np.testing.assert_array_equal(got, rel[:, a - b + ks - 1])
    with pytest.raises(ValueError, match="exceeds the kernel size"):
        k6.relative_embeddings(torch.from_numpy(rel), ks, ks + 1)


# --- AxialAttention ---------------------------------------------------------

ATTN = dict(c_in=8, out=16, groups=4, ks=8)


def _jax_attention(mode, stride, width_axis, x, use_pallas):
    return JaxAxialAttention(ATTN["out"], ATTN["groups"], ATTN["ks"], stride, width_axis, mode,
                             use_pallas=use_pallas)


@pytest.fixture(scope="module")
def attention_cases():
    """Per (mode, axis): JAX variables off identity, the input, JAX eval
    output (XLA path) and the port module loaded with the same weights."""
    cases = {}
    x = np.random.default_rng(3).standard_normal((2, 8, 6, ATTN["c_in"])).astype(np.float32)
    for mode in ("base", "gated", "wopos"):
        for stride, width_axis in ((1, False), (2, True)):
            m = _jax_attention(mode, stride, width_axis, x, False)
            v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
            _perturb(np.random.default_rng(4), v["params"], v["batch_stats"])
            v = jax.tree_util.tree_map(np.asarray, v)
            ref = np.asarray(m.apply(v, jnp.asarray(x), train=False))
            cases[mode, width_axis] = (v, x, ref, stride)
    return cases


def _port_attention(mode, width_axis, stride, v, use_kernels):
    sd = {}
    port_convert._axial_attention(sd, "a", v["params"], v["batch_stats"])
    attn = AxialAttention(ATTN["c_in"], ATTN["out"], ATTN["groups"], ATTN["ks"], stride,
                          width_axis, mode, use_kernels=use_kernels)
    attn.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    return attn.eval()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("width_axis", [False, True])
@pytest.mark.parametrize("mode", ["base", "gated", "wopos"])
def test_axial_attention_matches_jax(attention_cases, mode, width_axis, use_kernels):
    """Both axes (the width pass with stride 2, then the average pool), H=8
    and W=6 against ks=8 (trap (b) on the width axis); module path and
    kernel path (the fold and the plain version) against the JAX module's
    XLA path with BN and gates off identity (traps (c), (d)), f32: 1e-4."""
    v, x, ref, stride = attention_cases[mode, width_axis]
    attn = _port_attention(mode, width_axis, stride, v, use_kernels)
    assert attn.kernel_path(_nchw(x)) is use_kernels
    with torch.no_grad():
        got = _nhwc(attn(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["base", "gated", "wopos"])
def test_fold_matches_jax(attention_cases, monkeypatch, mode):
    """The port's fold against the operands the JAX module hands its Pallas
    kernel (captured): similarity scales term-major [qk, qr, kr] with the
    gates, output scales from the (g, gp, 2)-paired BN, both output shifts
    summed, and q/k/v from the projection with bn_qkv folded in."""
    v, x, _, stride = attention_cases[mode, False]
    seen = {}

    def capture(q, k, vv, q_emb, k_emb, v_emb, sim_scale, sim_shift, out_scale, out_shift,
                wopos=False, interpret=False):
        seen.update(q=q, k=k, v=vv, q_emb=q_emb, sim_scale=sim_scale, out_scale=out_scale,
                    out_shift=out_shift)
        return jnp.zeros(q.shape[:2] + (ATTN["out"],), q.dtype)

    monkeypatch.setattr(jax_k6, "fused_axial_attention", capture)
    _jax_attention(mode, stride, False, x, True).apply(v, jnp.asarray(x), train=False)
    w = k6.fold_axial_params(_port_attention(mode, False, stride, v, True))
    np.testing.assert_allclose(w.sim_scale.numpy(), np.asarray(seen["sim_scale"]), rtol=1e-6)
    np.testing.assert_allclose(w.out_scale.numpy(), np.asarray(seen["out_scale"]), rtol=1e-6)
    np.testing.assert_allclose(w.out_shift.numpy(), np.asarray(seen["out_shift"]).sum(0),
                               rtol=1e-6, atol=1e-7)
    assert (w.relative is None) == (seen["q_emb"] is None)
    with torch.no_grad():
        qkv = torch.nn.functional.conv2d(_nchw(x), w.qkv_weight, w.qkv_bias)
    g, gp = ATTN["groups"], ATTN["out"] // ATTN["groups"]
    rows = k6.axis_rows(qkv, False).reshape(-1, x.shape[1], g, 2 * gp).numpy()
    for got, key in ((rows[..., :gp // 2], "q"), (rows[..., gp // 2:gp], "k"),
                     (rows[..., gp:], "v")):
        np.testing.assert_allclose(got, np.asarray(seen[key]), rtol=0, atol=1e-5)


# --- the wrapper --------------------------------------------------------------


def _k6_args(**over):
    g, gp, ks = 2, 4, 8
    a = dict(qkv=torch.zeros(1, 2 * g * gp, 5, 7, dtype=torch.bfloat16).contiguous(
                 memory_format=CL),
             relative=torch.zeros(2 * gp, 2 * ks - 1), sim_scale=torch.zeros(3, g),
             out_scale=torch.zeros(2, g, gp), out_shift=torch.zeros(g, gp),
             kernel_size=ks, width_axis=True)
    a.update(over)
    return a


@pytest.mark.parametrize("over,err", [
    ({}, None),
    ({"relative": None}, None),                                                  # wopos
    ({"qkv": torch.zeros(1, 16, 5, 7).contiguous(memory_format=CL)}, TypeError),   # f32 qkv
    ({"qkv": torch.zeros(1, 16, 5, 7, dtype=torch.bfloat16)}, ValueError),        # NCHW memory
    ({"qkv": torch.zeros(1, 24, 5, 7, dtype=torch.bfloat16
                         ).contiguous(memory_format=CL)}, ValueError),            # channels
    ({"out_scale": torch.zeros(2, 2, 3), "out_shift": torch.zeros(2, 3)}, ValueError),  # gp 3
    ({"kernel_size": 6}, ValueError),                                             # L > ks
    ({"relative": torch.zeros(8, 13)}, ValueError),                               # not ks's table
    ({"sim_scale": torch.zeros(3, 2, dtype=torch.bfloat16)}, TypeError),
    ({"out_shift": torch.zeros(4, 2).t()}, ValueError),                           # not contiguous
    ({"qkv": torch.zeros(1, 16, 5, 513, dtype=torch.bfloat16).contiguous(memory_format=CL),
      "kernel_size": 600, "relative": torch.zeros(8, 1199)}, ValueError),        # L > 512
])
def test_kernel_argument_checks(over, err):
    a = _k6_args(**over)
    if err is None:
        assert k6._check_kernel_args(**a) == (1, 2, 4, 7)
    else:
        with pytest.raises(err):
            k6._check_kernel_args(**a)


def test_wrapper_rejects_other_devices():
    a = _k6_args()
    a["qkv"] = a["qkv"].to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k6.fused_axial_attention(**a)


def test_kernel_dispatch():
    attn = AxialAttention(8, 16, 4, 8, use_kernels=None).eval()
    x = torch.zeros(1, 8, 8, 6)
    assert not attn.kernel_path(x)                       # auto: bf16 CUDA only
    attn.use_kernels = True
    assert attn.kernel_path(x)
    assert attn.train().kernel_path(x)                   # training: K7 (plain version here)
    attn.use_kernels = None
    assert not attn.kernel_path(x)                       # auto in training: bf16 CUDA only
    wopos = AxialAttention(8, 16, 4, 8, mode="wopos", use_kernels=True)
    assert wopos.eval().kernel_path(x) and not wopos.train().kernel_path(x)   # no train kernel
    attn.eval()
    # no shape gate: gp 6, which the CUDA kernel does not take, stays on the
    # kernel path (its plain version here; on the card the wrapper raises)
    odd = AxialAttention(8, 24, 4, 8, mode="gated", use_kernels=True)
    odd.draw_parameters(torch.Generator().manual_seed(0))
    odd.eval()
    assert odd.kernel_path(x)
    xr = torch.randn(1, 8, 8, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = odd(xr)
        odd.use_kernels = False
        ref = odd(xr)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    a = _k6_args(out_scale=torch.zeros(2, 2, 6), out_shift=torch.zeros(2, 6),
                 relative=torch.zeros(12, 15),
                 qkv=torch.zeros(1, 24, 5, 7, dtype=torch.bfloat16).contiguous(memory_format=CL))
    with pytest.raises(ValueError, match="use_kernels=False"):
        k6._check_kernel_args(**a)


# --- the five registry names ---------------------------------------------------


@pytest.fixture(scope="module", params=NAMES)
def jax_model(request):
    """A JAX registry model at 32px, variables off identity, its input and
    its eval logits (XLA path)."""
    name = request.param
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    m = jax_create_model(name, image_size=SIZE)
    v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _perturb(rng, v["params"], v["batch_stats"])
    v = jax.tree_util.tree_map(np.asarray, v)
    ref = np.asarray(m.module.apply(v, jnp.asarray(x), train=False)["main"])
    return name, m, v, x, ref


def _port(name, v, use_kernels):
    m = create_model(name, device="cpu", image_size=SIZE, use_kernels=use_kernels)
    m.module.load_state_dict(from_jax_variables(name, v), strict=True)
    return m


@pytest.mark.parametrize("use_kernels", [False, True])
def test_eval_logits_match_jax(jax_model, use_kernels):
    """Module path, and kernel path (fold + plain version on the CPU), f32,
    against the JAX eval logits: 1e-3. The CPU runs no kernel launch."""
    name, _, v, x, ref = jax_model
    before = k6.LAUNCHES["fused_axial_attention"]
    with torch.no_grad():
        got = _nhwc(_port(name, v, use_kernels).module(_nchw(x))["main"])
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert k6.LAUNCHES["fused_axial_attention"] == before


def test_state_dict_keys_round_trip(jax_model):
    """The port's state_dict read back by the JAX package's converter gives
    the JAX variables, every leaf exact (relative and gates included)."""
    name, _, v, _, _ = jax_model
    sd = _port(name, v, None).module.state_dict()
    back = convert_state_dict(name, {k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)
                         for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_predictor_probs_match_jax(jax_model):
    """Trap (f): make_predictor rounds every parameter to bf16, relative and
    the scalar gates included, as the JAX cast_params_for_inference does;
    f32 compute on both sides: probabilities at 2e-3. The kernel path's
    predictor folds once and gives the same logits as folding per call."""
    name, jm, v, x, _ = jax_model
    m = _port(name, v, None)
    jv = jax.tree_util.tree_map(jnp.asarray, v)   # numpy leaves cannot take traced indices
    probs_ref = np.asarray(jax_make_predictor(jm, jv, "probs")(jnp.asarray(x)))
    probs = _nhwc(make_predictor(m, None, "probs")(_nchw(x)))
    np.testing.assert_allclose(probs, probs_ref, rtol=2e-3, atol=2e-3)
    cast = cast_params_for_inference(m.module)
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
    mk = _port(name, v, True)
    logits = make_predictor(mk, None, "logits")(_nchw(x))
    with torch.no_grad():
        direct = cast_params_for_inference(mk.module)(_nchw(x))["main"]
    np.testing.assert_array_equal(logits.numpy(), direct.numpy())


def test_registry_spec_fields_match_jax():
    assert set(NAMES) <= set(list_models())
    for name in NAMES:
        spec, jax_spec = create_model(name, device="cpu", image_size=SIZE).spec, JAX_REGISTRY[name]
        assert (spec.requires_image_size, spec.default_image_size) == (
            jax_spec.requires_image_size, jax_spec.default_image_size) == (False, 128)
        for key in ("main", "side1"):
            assert spec.loss_weight(key) == jax_spec.loss_weight(key)
    # the JAX registry's dead kwargs are accepted and change nothing
    a = create_model("medt", device="cpu", image_size=SIZE, layers=(2, 2, 2, 2), s=0.5,
                     norm_layer=None, zero_init_residual=True)
    b = create_model("medt", device="cpu", image_size=SIZE)
    assert {k: t.shape for k, t in a.module.state_dict().items()} == {
        k: t.shape for k, t in b.module.state_dict().items()}
    assert create_model("gated", device="cpu").image_size == 128
    blocks = [m for m in create_model("gated", device="cpu").module.modules()
              if isinstance(m, AxialAttention)]
    assert len(blocks) == 16 and {b.group_planes for b in blocks} == {2, 4, 8, 16}
