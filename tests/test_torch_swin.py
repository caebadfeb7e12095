"""swin_unet_v2 in the port against the JAX package (CPU).

K2 (``swin_window_attention``): on the CPU the port's wrapper runs its plain
version, held here against the JAX Pallas kernel in interpret mode and
against the JAX reference, with the traps the port has to get right: q
arrives pre-scaled (the scale survives only at the 1e-6 clamp), tau is a
per-element divisor clipped from below only, window b reads
``mask[b % nW]``. The CUDA kernel itself is held against the plain version
by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card.
The helpers, the modules and the whole model (f32) run against the JAX eval
forward, whose CPU path (the XLA one) is the oracle.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.models import swin_unet_v2 as jswin
from unet_zoo_tpu.ops.pallas import window_attention as jax_k2
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import make_predictor as jax_make_predictor
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.models import swin_unet_v2 as pswin
from unet_zoo_tpu_torch.nn import init_weights
from unet_zoo_tpu_torch.nn.transformer import DropPath
from unet_zoo_tpu_torch.ops.kernels import window_attention as k2
from unet_zoo_tpu_torch.utils import convert as port_convert
from unet_zoo_tpu_torch.utils.convert import from_jax_variables
from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference, make_predictor

torch.set_num_threads(1)

CL = torch.channels_last


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _tau(rng, shape, clipped=True):
    """tau off its init: U(0.05, 1.5), with every 17th entry at 0.005, below
    the 0.01 clip; U(0.1, 1.5) without (``clipped=False``), for the whole
    model, where cosines over tau 0.005 make the attention near one-hot
    and its choices chaotic in the last bits of f32."""
    if not clipped:
        return rng.uniform(0.1, 1.5, shape).astype(np.float32)
    tau = rng.uniform(0.05, 1.5, shape).astype(np.float32)
    tau.reshape(-1)[::17] = 0.005
    return tau


# --- K2 --------------------------------------------------------------------


def _k2_case(seed, b_, nh, n, hd, nw):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b_, nh, n, hd)).astype(np.float32) for _ in range(3))
    q *= hd ** -0.5                          # pre-scaled, as the model hands it over
    q[0, 0, 1] = 0.0                         # |q| |k| = 0: the 1e-6 clamp
    k[1, 0, 2] = 0.0
    tau = _tau(rng, (nh, n, n))
    bias = (3.0 * rng.standard_normal((nh, n, n))).astype(np.float32)
    mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)
    if nw == 1:
        mask[:] = 0.0
    return q, k, v, tau, bias, mask


@pytest.mark.parametrize("b_,nh,n,hd,nw", [
    (8, 3, 16, 8, 1),
    (8, 3, 16, 8, 4),
    (8, 2, 49, 16, 4),      # N 49 (window 7), tau below 0.01, a zero q row
])
def test_reference_matches_jax_kernel(b_, nh, n, hd, nw):
    """float32 on both sides: the JAX kernel in interpret mode and the JAX
    reference, 1e-5. Without a shift the port takes no mask."""
    q, k, v, tau, bias, mask = _k2_case(b_ + n, b_, nh, n, hd, nw)
    j = [jnp.asarray(a) for a in (q, k, v, tau, bias, mask)]
    want = np.asarray(jax_k2.swin_window_attention(*j, interpret=True))
    want_ref = np.asarray(jax_k2.swin_window_attention_reference(*j))
    got = k2.swin_window_attention(_t(q), _t(k), _t(v), _t(tau), _t(bias),
                                   None if nw == 1 else _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-5)


def test_tau_is_a_per_element_divisor_clipped_from_below():
    """Trap: tau divides each (head, i, j) and is clipped at 0.01 from below
    only. With v the identity the output rows are the softmax rows, whose
    log differences are the logits' differences, written out here by hand."""
    q, k, _, tau, bias, _ = (_t(a) for a in _k2_case(3, 2, 2, 4, 4, 1))
    tau[1, 2, 3], tau[0, 0, 0], tau[1, 2, 1] = 0.001, 7.0, 1.0
    eye = torch.eye(4).expand(2, 2, 4, 4)
    logp = k2.swin_window_attention_reference(q, k, eye, tau, bias).log()
    cos = lambda b, h, i, j: ((q[b, h, i] @ k[b, h, j]) / torch.clamp_min(
        q[b, h, i].norm() * k[b, h, j].norm(), 1e-6)).item()
    for b, h, i, j, divisor in ((0, 1, 2, 3, 0.01), (0, 0, 0, 0, 7.0), (1, 1, 2, 3, 0.01)):
        want = (cos(b, h, i, j) / divisor + bias[h, i, j].item()) - (
            cos(b, h, i, 1) / max(tau[h, i, 1].item(), 0.01) + bias[h, i, 1].item())
        assert abs((logp[b, h, i, j] - logp[b, h, i, 1]).item() - want) < 1e-4


def test_mask_is_read_by_window():
    """Trap: window b reads mask[b % nW] (the TPU kernel's BlockSpec
    ``i % nblk``), not mask[b // nW]: with nW = 2 and 4 windows, only
    windows 1 and 3 see the mask that is not zero."""
    q, k, v, tau, bias, _ = (_t(a) for a in _k2_case(4, 4, 1, 3, 2, 1))
    mask = torch.zeros(2, 3, 3)
    mask[1, :, 0] = -100.0
    plain = k2.swin_window_attention_reference(q, k, v, tau, bias)
    masked = k2.swin_window_attention_reference(q, k, v, tau, bias, mask)
    assert torch.equal(masked[[0, 2]], plain[[0, 2]])
    assert ((masked[[1, 3]] - plain[[1, 3]]).abs().amax(dim=(1, 2, 3)) > 1e-3).all()


def test_wrapper_argument_errors_name_module_path():
    q, k, v, tau, bias, mask = (_t(a) for a in _k2_case(0, 4, 2, 16, 8, 2))
    bf = lambda t: t.to(torch.bfloat16)
    good = dict(q=bf(q), k=bf(k), v=bf(v), tau=tau, bias=bias, mask=mask)
    assert k2._check_kernel_args(**good) == (4, 2, 16, 8, 2)
    bad = [dict(q=q.half(), k=k.half(), v=v.half()),                  # float16
           dict(k=bf(k[:, :, :8])),                                    # k's shape
           dict(tau=tau[:, :8]),                                       # tau's shape
           dict(bias=bias.to(torch.bfloat16)),                         # bias not f32
           dict(mask=torch.zeros(3, 16, 16)),                          # nW does not divide B_
           dict(q=bf(q).transpose(-1, -2).contiguous().transpose(-1, -2)),   # channel stride
           dict(q=bf(torch.zeros(4, 2, 300, 8)), k=bf(torch.zeros(4, 2, 300, 8)),
                v=bf(torch.zeros(4, 2, 300, 8)))]                      # N above 256
    for change in bad:
        with pytest.raises(ValueError, match="use_kernels=False"):
            k2._check_kernel_args(**{**good, **change})
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.swin_window_attention(q.to("meta"), k.to("meta"), v.to("meta"), tau, bias)


# --- helpers, DropPath --------------------------------------------------------


@pytest.mark.parametrize("nh,nw", [(7, 7), (4, 4), (8, 8), (3, 5)])
def test_log_relative_coords_match_jax(nh, nw):
    np.testing.assert_array_equal(pswin._log_relative_coords(nh, nw),
                                  jswin._log_relative_coords(nh, nw))


@pytest.mark.parametrize("h,w,window,shift", [(56, 56, 7, 3), (16, 16, 4, 2), (64, 64, 8, 4),
                                              (8, 12, 4, 2)])
def test_shift_attn_mask_matches_jax(h, w, window, shift):
    got = pswin._shift_attn_mask(h, w, window, shift)
    np.testing.assert_array_equal(got, jswin._shift_attn_mask(h, w, window, shift))
    assert set(np.unique(got)) <= {0.0, -100.0}


def test_window_partition_and_reverse_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 5)).astype(np.float32)
    win = pswin.window_partition(_t(x), 4)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jswin.window_partition(
        jnp.asarray(x), 4)))
    np.testing.assert_array_equal(pswin.window_reverse(win, 4, 8, 12).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jswin.window_reverse(jnp.asarray(win.numpy()), 4, 8, 12)), x)


def test_drop_path():
    """Eval and rate 0 are the identity and draw nothing; training keeps
    whole samples, scaled by 1 / keep, from the generator's uniforms."""
    x = torch.randn(64, 5, 3)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    assert DropPath(0.25).eval()(x, g) is x and DropPath(0.0).train()(x, g) is x
    assert torch.equal(g.get_state(), state)
    got = DropPath(0.25).train()(x, g)
    u = torch.rand((64, 1, 1), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, x / 0.75 * torch.floor(0.75 + u), rtol=0, atol=0)
    kept = (got != 0).all(dim=(1, 2))
    assert 0 < kept.sum() < 64 and ((got == 0).all(dim=(1, 2)) | kept).all()


# --- modules ---------------------------------------------------------------------


def _jax_init(module, *args, seed=0, **kw):
    v = module.init(jax.random.PRNGKey(seed), *args, **kw)
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(v))


def _sharpen_attn(rng, a, clipped=True):
    """tau off init (``_tau``) and a CPB bias of a few units, in a JAX
    ``attn`` params dict."""
    a["tau"] = _tau(rng, a["tau"].shape, clipped)
    a["cpb_fc2"]["kernel"] = a["cpb_fc2"]["kernel"] * 8.0
    a["cpb_fc2"]["bias"] = rng.standard_normal(a["cpb_fc2"]["bias"].shape).astype(np.float32)


def _ln_off_identity(rng, p):
    for key, sub in p.items():
        if isinstance(sub, dict):
            if set(sub) == {"scale", "bias"}:
                sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape).astype(np.float32)
                sub["bias"] = (0.1 * rng.standard_normal(sub["bias"].shape)).astype(np.float32)
            else:
                _ln_off_identity(rng, sub)


def _attn_sd(a):
    sd = {}
    for name, key in (("qkv", "qkv"), ("proj", "proj"), ("cpb_fc1", "cpb.fc1"),
                      ("cpb_fc2", "cpb.fc2")):
        port_convert._dense(sd, key, a[name])
    sd["tau"] = _t(a["tau"])
    return sd


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("window,nw", [(4, 1), (4, 4), (7, 2)])
def test_window_attention_matches_jax(use_kernels, window, nw):
    """Module path and kernel path (the plain version on the CPU) against
    the JAX module (XLA path), with and without a mask: 1e-4."""
    rng = np.random.default_rng(window + nw)
    dim, nh, n = 24, 3, window * window
    x = rng.standard_normal((2 * nw, n, dim)).astype(np.float32)
    mask = None
    if nw > 1:
        mask = np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0).astype(np.float32)
    jm = jswin.WindowAttentionV2((window, window), nh)
    v = _jax_init(jm, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    _sharpen_attn(rng, v["params"])
    want = np.asarray(jm.apply(v, jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
    pm = pswin.WindowAttentionV2(dim, (window, window), nh, use_kernels=use_kernels)
    pm.load_state_dict(_attn_sd(v["params"]), strict=True)
    with torch.no_grad():
        got = pm.eval()(_t(x), None if mask is None else _t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("res,window,shift", [
    ((8, 8), 4, 2),      # shifted: roll, mask of 4 windows, roll back
    ((4, 4), 7, 3),      # resolution below the window: window 4, no shift
    ((8, 8), 8, 4),      # resolution equal to the window: no shift
])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_swin_block_matches_jax(res, window, shift, use_kernels):
    rng = np.random.default_rng(res[0] + window)
    dim, nh = 16, 2
    x = rng.standard_normal((2, res[0] * res[1], dim)).astype(np.float32)
    jm = jswin.SwinBlockV2(res, nh, window, shift)
    v = _jax_init(jm, jnp.asarray(x))
    _sharpen_attn(rng, v["params"]["attn"])
    _ln_off_identity(rng, v["params"])
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = pswin.SwinBlockV2(dim, res, nh, window, shift, use_kernels=use_kernels)
    sd = {}
    port_convert._swin_block(sd, "b", v["params"])
    pm.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    assert pm.window == min(window, *res) and pm.shift == (shift if min(res) > window else 0)
    assert pm.attn.tau.shape == (nh, pm.window ** 2, pm.window ** 2)
    with torch.no_grad():
        got = pm.eval()(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_patch_merging_matches_jax():
    """Trap: the neighbour order is [0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
    [1::2, 1::2] (rows first), not the obvious one."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 6)).astype(np.float32)
    jm = jswin.PatchMerging((8, 8))
    v = _jax_init(jm, jnp.asarray(x))
    _ln_off_identity(rng, v["params"])
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = pswin.PatchMerging((8, 8), 6)
    sd = {}
    port_convert._patch_resize(sd, "m", v["params"], "reduction")
    pm.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(pm(_t(x)).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("final,defer", [(False, False), (True, False), (True, True)])
def test_patch_expand_matches_jax(final, defer):
    """Depth-to-space as reshape (b, h, w, p, p, c) then (0, 1, 3, 2, 4, 5);
    the x4 head's deferred form is the same values before the rearrange."""
    rng = np.random.default_rng(2)
    c = 8 if final else 12
    x = rng.standard_normal((2, 16, c)).astype(np.float32)
    jm = (jswin.FinalPatchExpandX4((4, 4), defer_rearrange=defer) if final
          else jswin.PatchExpand((4, 4)))
    v = _jax_init(jm, jnp.asarray(x))
    _ln_off_identity(rng, v["params"])
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    pm = pswin.FinalPatchExpandX4((4, 4), c) if final else pswin.PatchExpand((4, 4), c)
    sd = {}
    port_convert._patch_resize(sd, "m", v["params"], "expand")
    pm.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = (pm(_t(x), defer_rearrange=defer) if final else pm(_t(x))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# --- the whole model ------------------------------------------------------------


CASES = {
    "64px": dict(image_size=64, window_size=4, embed_dim=24),
    "224px": dict(image_size=224, window_size=7, embed_dim=24, depths=(2, 1, 1, 1)),
    "64px_mlp": dict(image_size=64, window_size=4, embed_dim=24, use_mlp=True),
}


def _perturb(rng, p):
    for key, sub in p.items():
        if key.startswith("layer") and "_blk" in key:
            _sharpen_attn(rng, sub["attn"], clipped=False)
    _ln_off_identity(rng, p)


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """A JAX swin_unet_v2, its variables with tau, the CPB bias and every
    LayerNorm off init, an input and its eval logits (XLA path)."""
    kw = CASES[case]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
    m = jax_create_model("swin_unet_v2", **kw)
    v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = jax.tree_util.tree_map(np.asarray, v)
    _perturb(rng, v["params"])
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
    return m, v, x, np.asarray(apply(v, jnp.asarray(x)))


def _port(case, v, use_kernels):
    m = create_model("swin_unet_v2", device="cpu", use_kernels=use_kernels, **CASES[case])
    m.module.load_state_dict(from_jax_variables("swin_unet_v2", v), strict=True)
    return m


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_eval_logits_match_jax(case, use_kernels):
    """Module path and kernel path (the plain K2 on the CPU), f32, against
    the JAX eval logits: 1e-3 (measured at most 2.3e-5, at 224px). The CPU launches
    no kernel."""
    _, v, x, ref = _jax_case(case)
    before = k2.LAUNCHES["swin_window_attention"]
    with torch.no_grad():
        got = _nhwc(_port(case, v, use_kernels).module(_nchw(x))["main"])
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert k2.LAUNCHES["swin_window_attention"] == before


@pytest.mark.parametrize("case", ["64px", "224px"])    # the JAX converter reads no MLP
def test_state_dict_round_trip(case):
    """The port's state_dict read back by the JAX package's converter gives
    the JAX variables, every leaf exact."""
    _, v, _, _ = _jax_case(case)
    sd = _port(case, v, None).module.state_dict()
    back = convert_state_dict("swin_unet_v2", {k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)
                         for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("tta", [False, True])
def test_predictor_probs_match_jax(tta):
    """make_predictor rounds every parameter (tau and the CPB MLP included)
    to bf16 as the JAX predictor does; f32 compute on both sides:
    probabilities at 2e-3, with and without flip TTA."""
    case = "64px"
    jm, v, x, _ = _jax_case(case)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    want = np.asarray(jax_make_predictor(jm, jv, "probs", tta=tta)(jnp.asarray(x)))
    for use_kernels in (False, True):
        got = _nhwc(make_predictor(_port(case, v, use_kernels), None, "probs", tta=tta)(
            _nchw(x)))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_frozen_tables(monkeypatch):
    """make_predictor builds K2's float32 tables once: clip(tau, 0.01) and the
    CPB table from the bf16-rounded parameters; no forward rebuilds them."""
    m = create_model("swin_unet_v2", device="cpu", image_size=32, window_size=4, embed_dim=12,
                     use_kernels=True)
    pred = make_predictor(m, None, "logits")
    calls = []
    monkeypatch.setattr(pswin.WindowAttentionV2, "kernel_tables", lambda self: calls.append(1))
    assert torch.isfinite(pred(torch.randn(1, 3, 32, 32))).all()
    assert calls == []


def test_cpb_table_kept_in_float32():
    """By design (ROADMAP Queue 3): in bf16 the kernel path's CPB table is
    the MLP computed in float32 from the bf16-rounded parameters, where the
    module path (and JAX) computes it in bf16; the two differ by the bf16
    rounding of the MLP's steps."""
    attn = pswin.WindowAttentionV2(48, (7, 7), 3, dtype=torch.bfloat16)
    init_weights(attn, torch.Generator().manual_seed(0))
    attn = cast_params_for_inference(attn).eval()
    tau, table = attn.kernel_tables()
    assert tau.dtype == table.dtype == torch.float32
    want = attn.cpb_bias(torch.float32)        # f32 arithmetic on the bf16 parameters
    torch.testing.assert_close(table, want, rtol=0, atol=0)
    module_path = attn.cpb_bias(torch.bfloat16).float()
    err = (module_path - table).abs().max().item()
    assert 0 < err <= 2 ** -6 * table.abs().max().item()
    torch.testing.assert_close(tau, attn.tau.float().clamp_min(0.01), rtol=0, atol=0)


def test_registry_spec_and_kwargs_match_jax():
    assert "swin_unet_v2" in list_models()
    spec, jax_spec = (create_model("swin_unet_v2", device="cpu", image_size=32, window_size=4,
                                   embed_dim=12).spec, JAX_REGISTRY["swin_unet_v2"])
    assert (spec.requires_image_size, spec.default_image_size) == (
        jax_spec.requires_image_size, jax_spec.default_image_size) == (True, None)
    assert spec.loss_weight("main") == jax_spec.loss_weight("main")
    with pytest.raises(ValueError, match="image_size"):
        create_model("swin_unet_v2", device="cpu")
    # the registry defaults, and the dead kwargs accepted and dropped
    m = create_model("swin_unet_v2", device="cpu", image_size=224).module
    attns = [b.attn for layer in (*m.layers, *m.layers_up[1:]) for b in layer.blocks]
    assert m.embed_dim == 96 and len(attns) == 14
    assert [a.num_heads for a in attns] == [3, 3, 6, 6, 12, 12, 24, 24, 12, 12, 6, 6, 3, 3]
    assert all(a.tau.shape[-1] == 49 for a in attns)
    assert m.layers[0].blocks[1].attn.qkv.bias is not None
    assert [b.drop_path.rate for b in m.layers[0].blocks] == [0.0, pytest.approx(0.1 / 7)]
    a = create_model("swin_unet_v2", device="cpu", image_size=32, window_size=4, embed_dim=12,
                     depths_decoder=(1, 2, 2, 2), use_checkpoint=True, final_upsample="x",
                     norm_layer=None)
    b = create_model("swin_unet_v2", device="cpu", image_size=32, window_size=4, embed_dim=12)
    assert {k: t.shape for k, t in a.module.state_dict().items()} == {
        k: t.shape for k, t in b.module.state_dict().items()}
    with pytest.raises(ValueError, match="built for 32px"):
        b.module(torch.zeros(1, 3, 64, 64))


def test_kernel_dispatch(monkeypatch):
    """None on the CPU: the module path. True: K2's wrapper (its plain version
    here, no launch counted) in all 14 blocks, the same logits as the module
    path. False: never. Training: the module path (no backward kernel)."""
    calls = []
    wrapper = k2.swin_window_attention
    monkeypatch.setattr(k2, "swin_window_attention",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    before = k2.LAUNCHES["swin_window_attention"]
    out = {}
    for use_kernels in (None, True, False):
        m = create_model("swin_unet_v2", device="cpu", image_size=64, window_size=4,
                         embed_dim=12, use_kernels=use_kernels)
        del calls[:]
        with torch.no_grad():
            out[use_kernels] = m.module(x)["main"]
        assert len(calls) == (14 if use_kernels else 0), use_kernels
        m.module.train()
        del calls[:]
        m.module(x)["main"].sum().backward()
        assert calls == []
    assert k2.LAUNCHES["swin_window_attention"] == before
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=1e-5)
    torch.testing.assert_close(out[None], out[False], rtol=0, atol=0)
