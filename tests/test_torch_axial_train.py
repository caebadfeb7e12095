"""MedT training in the port against the JAX package (CPU).

K7 (``fused_axial_train``): on the CPU the port's wrapper runs its plain
version, held here against the JAX Pallas kernel in interpret mode (values,
moments and all nine gradients) with an axis shorter than the kernel size.
AxialAttention in train mode (module path and K7 path) and one whole
``make_train_step`` of ``gated`` run against the JAX package's XLA path,
its CPU path. The CUDA kernel itself is held against the plain version by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.models.medt_net import AxialAttention as JaxAxialAttention
from unet_zoo_tpu.models.medt_net import ResAxialAttentionUNet as JaxResAxialAttentionUNet
from unet_zoo_tpu.models.medt_net import _relative_index as jax_relative_index
from unet_zoo_tpu.ops.pallas.axial_train import fused_axial_train as jax_fused_axial_train
from unet_zoo_tpu.train.steps import create_train_state as jax_create_train_state
from unet_zoo_tpu.train.steps import make_train_step as jax_make_train_step
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.medt_net import AxialAttention, ResAxialAttentionUNet
from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.utils import convert as port_convert
from unet_zoo_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

CL = torch.channels_last
EPS = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


# --- K7 -----------------------------------------------------------------------


def _k7_inputs(seed, n=6, length=16, g=2, gp=4, ks=20):
    """The shapes of tests/test_axial_train.py, on an axis shorter than ks."""
    rng = np.random.default_rng(seed)
    c = gp // 2
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k = r(n, length, g, c), r(n, length, g, c)
    return dict(q=q, k=k, qg=q * 0.3, kg=k * 0.7, v=r(n, length, g, gp),
                relative=r(2 * gp, 2 * ks - 1) / np.sqrt(gp),
                gamma=(r(3, g) * 0.2 + 1.0).astype(np.float32)), ks


def _jax_k7(q, k, qg, kg, v, relative, gamma, ks):
    """The JAX kernel (interpret mode) on tables cut from ``relative``."""
    c, gp, length = q.shape[-1], v.shape[-1], q.shape[1]
    emb = relative[:, jnp.asarray(jax_relative_index(ks))].reshape(2 * gp, ks, ks)
    emb = emb[:, :length, :length]
    return jax_fused_axial_train(q, k, qg, kg, v, emb[:c], emb[c:gp].transpose(0, 2, 1),
                                 emb[gp:], gamma, EPS, True)


def test_reference_matches_jax_kernel_values_and_moments():
    """float32 on both sides, sums in other orders: moments at 1e-5, sv and
    sve at 1e-5 (the JAX test holds its kernel to its XLA path at 2e-4)."""
    a, ks = _k7_inputs(0)
    want = _jax_k7(*(jnp.asarray(a[n]) for n in a), ks)
    got = k7.fused_axial_train(*(torch.from_numpy(a[n]) for n in a), ks, EPS)
    for name, w, t in zip(("sv", "sve", "mu", "var"), want, got):
        assert tuple(t.shape) == w.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert not got[2].requires_grad and not got[3].requires_grad


def test_reference_gradients_match_jax_kernel():
    """All nine gradients (q, k, qg, kg, v, the q/k/v rows of ``relative``,
    i.e. the three tables summed along their diagonals, and gamma) under a
    seeded upstream gradient, against jax.grad of the JAX kernel's custom
    VJP: 1e-4 (float32, other summation orders; the JAX test holds its VJP
    to autodiff at 5e-4)."""
    a, ks = _k7_inputs(1)
    rng = np.random.default_rng(42)
    shape = a["v"].shape
    w1, w2 = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(
        np.float32)
    names = list(a)

    def loss_jax(*args):
        sv, sve, _, _ = _jax_k7(*args, ks)
        return jnp.sum(sv * w1) + jnp.sum(sve * w2)

    want = jax.grad(loss_jax, argnums=tuple(range(7)))(*(jnp.asarray(a[n]) for n in names))
    ts = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    sv, sve, _, _ = k7.fused_axial_train(*ts, ks, EPS)
    ((sv * torch.from_numpy(w1)).sum() + (sve * torch.from_numpy(w2)).sum()).backward()
    gp, c = shape[-1], shape[-1] // 2
    pairs = [(n, t.grad.numpy(), np.asarray(w)) for n, t, w in zip(names, ts, want)]
    rel_g, rel_w = pairs[5][1], pairs[5][2]
    pairs[5:6] = [("q_emb", rel_g[:c], rel_w[:c]), ("k_emb", rel_g[c:gp], rel_w[c:gp]),
                  ("v_emb", rel_g[gp:], rel_w[gp:])]
    assert len(pairs) == 9
    for name, g_port, g_jax in pairs:
        np.testing.assert_allclose(g_port, g_jax, rtol=1e-4, atol=1e-4, err_msg=name)
    # the columns no offset of an axis shorter than ks reaches get nothing
    assert np.all(rel_g[:, :ks - 16] == 0) and np.all(rel_g[:, ks + 15:] == 0)


# --- K7's wrapper ------------------------------------------------------------------


def _k7_args(**over):
    n, length, g, gp, ks = 3, 5, 2, 4, 8
    bf = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    a = dict(q=bf(n, length, g, gp // 2), k=bf(n, length, g, gp // 2),
             qg=bf(n, length, g, gp // 2), kg=bf(n, length, g, gp // 2), v=bf(n, length, g, gp),
             relative=torch.zeros(2 * gp, 2 * ks - 1), gamma=torch.zeros(3, g), kernel_size=ks)
    a.update(over)
    return a


@pytest.mark.parametrize("over,err", [
    ({}, None),
    ({"v": torch.zeros(3, 10, 2, 4, dtype=torch.bfloat16)[:, ::2]}, None),         # strided rows
    ({"q": torch.zeros(3, 5, 2, 2)}, TypeError),                                   # f32
    ({"v": torch.zeros(3, 5, 2, 6, dtype=torch.bfloat16)}, ValueError),            # v width
    ({"kg": torch.zeros(3, 5, 2, 4, dtype=torch.bfloat16)[..., ::2]}, ValueError),  # channels
    ({"gamma": torch.zeros(2, 3).t()}, ValueError),                               # contiguity
    ({"relative": torch.zeros(8, 13)}, ValueError),                               # not ks's table
    ({"relative": torch.zeros(8, 15, dtype=torch.float64)}, TypeError),
    ({"kernel_size": 4, "relative": torch.zeros(8, 7)}, ValueError),              # L > ks
])
def test_kernel_argument_checks(over, err):
    a = _k7_args(**over)
    if err is None:
        assert k7._check_kernel_args(**a) == (3, 5, 2, 4)
    else:
        with pytest.raises(err):
            k7._check_kernel_args(**a)


@pytest.mark.parametrize("gp,length", [(6, 16), (4, 129)])
def test_kernel_argument_checks_name_the_module_path(gp, length):
    """gp outside the kernel's builds, or an axis above 128 (the JAX gate,
    every pass of gated at 256px): the error names use_kernels=False."""
    bf = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    c = gp // 2
    a = _k7_args(q=bf(1, length, 2, c), k=bf(1, length, 2, c), qg=bf(1, length, 2, c),
                 kg=bf(1, length, 2, c), v=bf(1, length, 2, gp),
                 relative=torch.zeros(2 * gp, 2 * length - 1), kernel_size=length)
    with pytest.raises(ValueError, match="use_kernels=False"):
        k7._check_kernel_args(**a)


def test_wrapper_rejects_other_devices():
    a = _k7_args()
    a = {k: (t.to("meta") if isinstance(t, torch.Tensor) else t) for k, t in a.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        k7.fused_axial_train(**a)


@pytest.mark.parametrize("rows,length,gp,split", [
    (1024, 128, 2, 2), (1024, 128, 4, 2), (512, 64, 8, 4), (256, 32, 16, 8), (37, 29, 4, 8),
    (64, 128, 32, 8),   # gp 32 at L = 128: one group per block
])
def test_group_split(rows, length, gp, split):
    assert k7.group_split(rows, 8, length, gp) == split
    for kind in range(4):
        assert k7._smem_bytes(kind, length, 8 // split, gp) <= 200 * 1024


def test_block_totals_and_moments():
    """Per-block float64 sums [N, split, R, g / split] -> [R, g] (group
    g = chunk * g / split + local group), then mu and the biased variance
    E[x^2] - mu^2 in float64."""
    part = torch.arange(2 * 2 * 6 * 3, dtype=torch.float64).reshape(2, 2, 6, 3)
    tot = k7._group_totals(part)
    assert tot.shape == (6, 6) and tot.dtype == torch.float64
    assert tot[4, 5].item() == part[:, 1, 4, 2].sum().item()
    x = torch.randn(3, 1000, dtype=torch.float64) * 0.01 + 100.0   # mean >> std
    sums = torch.cat([x.sum(1, keepdim=True), (x * x).sum(1, keepdim=True)]).repeat(1, 2)
    sums = sums.reshape(2, 3, 2).reshape(6, 2)
    mu, var = k7._moments(sums, 1000.0)
    assert mu.dtype == var.dtype == torch.float32
    torch.testing.assert_close(var[:, 0], x.var(1, unbiased=False).float(), rtol=1e-3, atol=0)


# --- AxialAttention in train mode -------------------------------------------------

ATTN = dict(c_in=8, out=16, groups=4, ks=8)


@pytest.fixture(scope="module")
def train_cases():
    """Per (mode, axis): JAX variables with gates off their initial values,
    the input, the upstream gradient, and the JAX train-mode output,
    parameter gradients and updated batch statistics (XLA path)."""
    cases = {}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 6, ATTN["c_in"])).astype(np.float32)
    for mode in ("base", "gated", "wopos"):
        for stride, width_axis in ((1, False), (2, True)):
            m = JaxAxialAttention(ATTN["out"], ATTN["groups"], ATTN["ks"], stride, width_axis,
                                  mode, use_pallas=False)
            v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
            for gate in ("f_qr", "f_kr", "f_sv", "f_sve"):
                if gate in v["params"]:
                    v["params"][gate] = jnp.asarray(rng.uniform(0.5, 1.5), jnp.float32)
            v = jax.tree_util.tree_map(np.asarray, v)
            out_shape = m.apply(v, jnp.asarray(x), train=False).shape
            w = rng.standard_normal(out_shape).astype(np.float32)

            def loss(params):
                out, mut = m.apply({"params": params, "batch_stats": v["batch_stats"]},
                                   jnp.asarray(x), train=True, mutable=["batch_stats"])
                return jnp.sum(out * w), (out, mut["batch_stats"])

            (_, (out, stats)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
            cases[mode, width_axis] = (v, x, w, stride, np.asarray(out),
                                       jax.tree_util.tree_map(np.asarray, grads),
                                       jax.tree_util.tree_map(np.asarray, stats))
    return cases


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("width_axis", [False, True])
@pytest.mark.parametrize("mode", ["base", "gated", "wopos"])
def test_axial_attention_train_matches_jax(train_cases, mode, width_axis, use_kernels):
    """Train-mode output (1e-4), every parameter gradient (1e-4 relative to
    the largest of its tensor, float32 sums in other orders) and the updated
    batch statistics (1e-6: Flax's biased running variance) on the module
    path and on the K7 path (its plain version here), against the JAX
    module's XLA path. ``wopos`` has no train kernel: both settings take its
    module path. The similarity BN's bias has an exactly zero gradient
    (softmax shift invariance); the JAX path reads rounding noise there."""
    v, x, w, stride, out_ref, grads_ref, stats_ref = train_cases[mode, width_axis]
    sd = {}
    port_convert._axial_attention(sd, "a", v["params"], v["batch_stats"])
    attn = AxialAttention(ATTN["c_in"], ATTN["out"], ATTN["groups"], ATTN["ks"], stride,
                          width_axis, mode, use_kernels=use_kernels)
    attn.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    attn.train()
    xt = _nchw(x)
    assert attn.kernel_path(xt) is (use_kernels and mode != "wopos")
    out = attn(xt)
    np.testing.assert_allclose(_nhwc(out), out_ref, rtol=0, atol=1e-4)
    (out * _nchw(w)).sum().backward()

    want = {}
    port_convert._axial_attention(want, "a", grads_ref, v["batch_stats"])
    for name, p in attn.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        ref = want["a." + name].numpy().reshape(g.shape)
        if name == "bn_similarity.bias":
            assert np.abs(ref).max() < 1e-5
            if attn.kernel_path(xt):
                assert p.grad is None or not p.grad.any()    # K7: exactly zero
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()), err_msg=name)
    got_stats = {}
    port_convert._axial_attention(got_stats, "a", v["params"], stats_ref)
    for name, buf in attn.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), got_stats["a." + name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)


# --- one whole train step ----------------------------------------------------------

SIZE = 32
LAYERS = (1, 1, 1, 1)   # both registries drop ``layers``: the modules are built here


def _adam_first_moment(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)).mu


@pytest.fixture(scope="module")
def jax_gated_step():
    """JAX ``gated`` (registry widths, layers (1, 1, 1, 1), 32px, XLA path),
    one make_train_step on a seeded uint8 batch: initial variables, metrics,
    the clipped gradient (AdamW's first moment after one step is 0.1 times
    it) and the variables after the step."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    masks = (rng.random((2, SIZE, SIZE, 1)) > 0.5).astype(np.uint8)
    m = jax_create_model("gated", image_size=SIZE, use_pallas=False)
    m = dataclasses.replace(m, module=JaxResAxialAttentionUNet(
        mode="gated", layers=LAYERS, img_size=SIZE, use_pallas=False))
    state = jax_create_train_state(m, jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)))
    init = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                               "batch_stats": state.batch_stats})
    state, metrics = jax_make_train_step(m)(state, jnp.asarray(images), jnp.asarray(masks))
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    grads = jax.tree_util.tree_map(lambda mu: mu / 0.1, as_np(_adam_first_moment(state.opt_state)))
    final = as_np({"params": state.params, "batch_stats": state.batch_stats})
    return (images, masks, init, {k: float(v) for k, v in metrics.items()},
            from_jax_variables("gated", {"params": grads, "batch_stats": init["batch_stats"]}),
            from_jax_variables("gated", final))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_gated_train_step_matches_jax(jax_gated_step, use_kernels):
    """One port step (K7's plain version on every positional axis pass, or
    the module path), float32, from the JAX initial variables and batch.

    Tolerances come from a float64 run of the port's train step on this
    model: both frameworks' float32 steps lie about 2e-5 from it in the
    logits and about 3e-3 of each tensor's largest entry in the gradients
    (train-mode BatchNorm's gradient cancels). So: loss and Dice at 1e-5;
    every clipped gradient at 1e-2 of its tensor's largest entry plus 1e-5
    (the clipped gradients' global norm is at most 1; the scalar gates'
    gradients, zero but for BatchNorm's eps, read 1e-7 to 1e-4 and differ
    by up to 2e-6); the batch statistics at 1e-5. AdamW's first step moves
    every parameter by about lr = 1e-4 times the sign of its gradient:
    where the gradient is resolved (above 5e-2 of its tensor's largest
    entry plus 1e-4) the updated parameter is held at 1e-6; elsewhere the
    sign may be noise and the two may differ by up to 2 lr. A similarity BN's bias has an
    exactly zero gradient (softmax shift invariance): the K7 path gives
    zero, so AdamW leaves the bias at its initial zero."""
    images, masks, init, metrics, grads_ref, final = jax_gated_step
    model = create_model("gated", device="cpu", image_size=SIZE)
    model = dataclasses.replace(model, module=ResAxialAttentionUNet(
        mode="gated", layers=LAYERS, img_size=SIZE, use_kernels=use_kernels))
    model.module.load_state_dict(from_jax_variables("gated", init), strict=True)
    state = create_train_state(model)
    got = make_train_step(model)(state, _nchw(images), _nchw(masks))
    assert got["loss"].dim() == 0 and got["dice"].dim() == 0 and state.step == 1
    np.testing.assert_allclose(got["loss"].item(), metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dice"].item(), metrics["dice"], rtol=1e-5)

    lr = 1e-4
    sd = model.module.state_dict()
    for name, p in model.module.named_parameters():
        g_ref = grads_ref[name].numpy()
        scale = np.abs(g_ref).max()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0, atol=1e-2 * scale + 1e-5,
                                   err_msg=f"grad {name}")
        resolved = np.abs(g_ref) > 5e-2 * scale + 1e-4
        diff = np.abs(sd[name].numpy() - final[name].numpy())
        assert np.all(diff[resolved] <= 1e-6), name
        assert np.all(diff <= 2.01 * lr), name
        if name.endswith("bn_similarity.bias") and use_kernels:
            assert not p.grad.any() and not sd[name].any(), name
    for name, buf in sd.items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), final[name].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        elif name.endswith("num_batches_tracked"):
            assert buf.item() == 1
