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
from unet_zoo_tpu.ops.pallas import axial_train as jax_axial_train
from unet_zoo_tpu.ops.pallas.axial_train import fused_axial_train as jax_fused_axial_train
from unet_zoo_tpu.train.steps import create_train_state as jax_create_train_state
from unet_zoo_tpu.train.steps import make_train_step as jax_make_train_step
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.medt_net import AxialAttention, ResAxialAttentionUNet
from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
from unet_zoo_tpu_torch.ops.kernels.axial_attention import (
    relative_embeddings as port_relative_embeddings)
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


@pytest.fixture(scope="module")
def jax_k7_grads():
    """Inputs 1 (L = 16 < ks = 20), a seeded upstream gradient of sv and sve,
    and jax.grad of the JAX kernel's custom VJP (interpret mode) for all seven
    operands."""
    a, ks = _k7_inputs(1)
    rng = np.random.default_rng(42)
    shape = a["v"].shape
    w1, w2 = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(
        np.float32)

    def loss_jax(*args):
        sv, sve, _, _ = _jax_k7(*args, ks)
        return jnp.sum(sv * w1) + jnp.sum(sve * w2)

    want = jax.grad(loss_jax, argnums=tuple(range(7)))(*(jnp.asarray(a[n]) for n in a))
    return a, ks, w1, w2, [np.asarray(w) for w in want]


def _grad_pairs(names, got, want, gp):
    """(name, port, jax) per gradient, ``relative``'s split into its q, k and v rows."""
    c = gp // 2
    pairs = list(zip(names, got, want))
    _, rel_g, rel_w = pairs[5]
    pairs[5:6] = [("q_emb", rel_g[:c], rel_w[:c]), ("k_emb", rel_g[c:gp], rel_w[c:gp]),
                  ("v_emb", rel_g[gp:], rel_w[gp:])]
    return pairs


def test_reference_gradients_match_jax_kernel(jax_k7_grads):
    """All nine gradients (q, k, qg, kg, v, the q/k/v rows of ``relative``,
    i.e. the three tables summed along their diagonals, and gamma) under a
    seeded upstream gradient, against jax.grad of the JAX kernel's custom
    VJP: 1e-4 (float32, other summation orders; the JAX test holds its VJP
    to autodiff at 5e-4)."""
    a, ks, w1, w2, want = jax_k7_grads
    names = list(a)
    ts = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    sv, sve, _, _ = k7.fused_axial_train(*ts, ks, EPS)
    ((sv * torch.from_numpy(w1)).sum() + (sve * torch.from_numpy(w2)).sum()).backward()
    pairs = _grad_pairs(names, [t.grad.numpy() for t in ts], want, a["v"].shape[-1])
    assert len(pairs) == 9
    for name, g_port, g_jax in pairs:
        np.testing.assert_allclose(g_port, g_jax, rtol=1e-4, atol=1e-4, err_msg=name)
    rel_g = ts[5].grad.numpy()
    # the columns no offset of an axis shorter than ks reaches get nothing
    assert np.all(rel_g[:, :ks - 16] == 0) and np.all(rel_g[:, ks + 15:] == 0)


# --- the kernels' arithmetic, in plain PyTorch ------------------------------------

def _forward_saved(t, ks):
    """What the stats and fwd grids compute, in float64: the terms [3, N, g,
    L, L], mu, var, a and rsqrt(var + eps) [3, g], the logits, each query
    row's max and sum of exp(logit - max) [N, g, L] and sv, sve [N, L, g, gp]."""
    q, k, qg, kg, v, rel, gamma = (t[x] for x in ("q", "k", "qg", "kg", "v", "relative", "gamma"))
    c, length = q.shape[-1], q.shape[1]
    gp = 2 * c
    emb = port_relative_embeddings(rel, ks, length)
    qe, ke, ve = emb[:c], emb[c:gp], emb[gp:]
    terms = torch.stack([torch.einsum("nigc,njgc->ngij", q, k),
                         torch.einsum("nigc,cij->ngij", qg, qe),
                         torch.einsum("njgc,cji->ngij", kg, ke)])
    mu = terms.mean(dim=(1, 3, 4))
    var = terms.var(dim=(1, 3, 4), unbiased=False)
    inv = torch.rsqrt(var + EPS)
    bc = lambda x: x[:, None, :, None, None]
    logit = (bc(gamma * inv) * terms).sum(0)
    mx = logit.max(dim=-1).values
    total = torch.exp(logit - mx[..., None]).sum(-1)
    sim = torch.exp(logit - mx[..., None]) / total[..., None]
    sv = torch.einsum("ngij,njgp->nigp", sim, v)
    sve = torch.einsum("ngij,pij->nigp", sim, ve)
    return dict(terms=terms, mu=mu, var=var, a=gamma * inv, inv=inv, logit=logit, mx=mx, total=total,
                sim=sim, sv=sv, sve=sve, qe=qe, ke=ke, ve=ve)


def _split_backward(t, ks, d_sv, d_sve):
    """The bwd, fin and combine grids in float64: one pass forms dpre from
    the saved log-sum-exp and D = Σ_p dsv sv + dsve sve, the partials of S,
    and for every output BatchNorm's e touches two partials, Σ dpre·operand
    and Σ x̂·operand; fin forms S and e = -a S / M; combine recombines
    a (dpre part) + e (x̂ part). Returns the parts and the seven gradients."""
    f = _forward_saved(t, ks)
    q, k, qg, kg, v, rel = (t[x] for x in ("q", "k", "qg", "kg", "v", "relative"))
    n, length, g, c = q.shape
    sim = torch.exp(f["logit"] - f["mx"][..., None]) / f["total"][..., None]
    d = ((d_sv * f["sv"]).sum(-1) + (d_sve * f["sve"]).sum(-1)).permute(0, 2, 1)  # [N, g, L]
    dsim = (torch.einsum("nigp,njgp->ngij", d_sv, v)
            + torch.einsum("nigp,pij->ngij", d_sve, f["ve"]))
    dpre = sim * (dsim - d[..., None])
    bc = lambda x: x[:, None, :, None, None]
    xh = (f["terms"] - bc(f["mu"])) * bc(f["inv"])
    s = (dpre * xh).sum(dim=(1, 3, 4))                                   # [3, g]
    e = -f["a"] * s / (n * length * length)
    ein = torch.einsum
    parts = {  # name: (dpre part, x̂ part, term)
        "q": (ein("ngij,njgc->nigc", dpre, k), ein("ngij,njgc->nigc", xh[0], k), 0),
        "k": (ein("ngij,nigc->njgc", dpre, q), ein("ngij,nigc->njgc", xh[0], q), 0),
        "qg": (ein("ngij,cij->nigc", dpre, f["qe"]), ein("ngij,cij->nigc", xh[1], f["qe"]), 1),
        "kg": (ein("ngij,cji->njgc", dpre, f["ke"]), ein("ngij,cji->njgc", xh[2], f["ke"]), 2),
        "q_emb": (ein("ngij,nigc->gcij", dpre, qg), ein("ngij,nigc->gcij", xh[1], qg), 1),
        "k_emb": (ein("ngij,njgc->gcji", dpre, kg), ein("ngij,njgc->gcji", xh[2], kg), 2),
    }
    grads = {}
    for name, (pa, px, term) in parts.items():
        if name.endswith("emb"):   # per group [g, c, L, L]: a and e per group, then the sum
            grads[name] = (f["a"][term][:, None, None, None] * pa
                           + e[term][:, None, None, None] * px).sum(0)
        else:
            grads[name] = f["a"][term][:, None] * pa + e[term][:, None] * px
    grads["v"] = ein("ngij,nigp->njgp", sim, d_sv)
    grads["v_emb"] = ein("ngij,nigp->pij", sim, d_sve)
    rel_leaf = rel.clone().requires_grad_()
    table = torch.cat([grads.pop("q_emb"), grads.pop("k_emb"), grads.pop("v_emb")])
    grads["relative"], = torch.autograd.grad(port_relative_embeddings(rel_leaf, ks, length),
                                             rel_leaf, table)
    grads["gamma"] = s
    return dict(f, parts=parts, s=s, e=e, d=d, dsim=dsim, sim=sim), grads


def _f64(a):
    return {name: torch.from_numpy(x).double() for name, x in a.items()}


def test_e_linear_split_recombined_is_the_two_pass_gradient(jax_k7_grads):
    """The one-pass backward: every gradient that BatchNorm's e = -a S / M
    touches, emitted as Σ dpre·operand and Σ x̂·operand and recombined as
    a (dpre part) + e (x̂ part) after S is known, equals the JAX kernel's
    two-pass gradient (B2 forms a dpre + e x̂ per pair with e already known)
    on all nine gradients, at 1e-4 (float64 here, float32 in JAX); and the x̂
    part matters: without it d_q misses by far more."""
    a, ks, w1, w2, want = jax_k7_grads
    t = _f64(a)
    cts = [torch.from_numpy(w).double() for w in (w1, w2)]
    saved, got = _split_backward(t, ks, *cts)
    names = list(a)
    pairs = _grad_pairs(names, [got[n].numpy() for n in names], want, a["v"].shape[-1])
    for name, g_port, g_jax in pairs:
        np.testing.assert_allclose(g_port, g_jax, rtol=1e-4, atol=1e-4, err_msg=name)
    dq_without_x = (saved["a"][0][:, None] * saved["parts"]["q"][0]).numpy()
    assert np.abs(dq_without_x - want[0]).max() > 100 * 1e-4


def test_row_statistics_saved_by_the_forward(jax_k7_grads):
    """What the fwd grid keeps for the backward: with each query row's
    max and sum, exp(logit - max) / sum is the softmax, so the backward
    needs no row max or sum (sv from it matches the JAX kernel's forward at
    1e-5); D_i = Σ_p dsv sv + dsve sve from float32 sv, sve equals Σ_j sim
    dsim to 1e-6 of its scale, while bf16-rounded sv, sve would move it a
    thousand times further."""
    a, ks, w1, w2, _ = jax_k7_grads
    t = _f64(a)
    d_sv, d_sve = (torch.from_numpy(w).double() for w in (w1, w2))
    saved, _ = _split_backward(t, ks, d_sv, d_sve)
    np.testing.assert_allclose(saved["sim"].sum(-1).numpy(), 1.0, rtol=0, atol=1e-12)
    want = _jax_k7(*(jnp.asarray(a[n]) for n in a), ks)
    np.testing.assert_allclose(saved["sv"].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(saved["sve"].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    exact = (saved["sim"] * saved["dsim"]).sum(-1)                     # [N, g, L]
    scale = exact.abs().max().item()

    def d_from(dt):
        sv, sve = saved["sv"].to(dt).double(), saved["sve"].to(dt).double()
        return ((d_sv * sv).sum(-1) + (d_sve * sve).sum(-1)).permute(0, 2, 1)

    assert (saved["d"] - exact).abs().max().item() <= 1e-12 * scale
    err32 = (d_from(torch.float32) - exact).abs().max().item()
    err16 = (d_from(torch.bfloat16) - exact).abs().max().item()
    assert err32 <= 1e-6 * scale and err16 >= 1e3 * err32
    # why the sims are divided by the row's own sum: one rounding of a
    # log-sum-exp scales a whole row of sims; D, summed from those sims, scales
    # with it and dsim does not, so the row of dpre no longer sums to zero and
    # d_q takes the error from the whole row (float64, a scale of 1 + 1e-6)
    k = t["k"]
    def dq_part(sim):
        sv = torch.einsum("ngij,njgp->nigp", sim, t["v"])
        sve = torch.einsum("ngij,pij->nigp", sim, saved["ve"])
        d = ((d_sv * sv).sum(-1) + (d_sve * sve).sum(-1)).permute(0, 2, 1)
        return torch.einsum("ngij,njgc->nigc", sim * (saved["dsim"] - d[..., None]), k)
    exact = dq_part(saved["sim"])
    scaled = dq_part(saved["sim"] * (1 + 1e-6))
    renorm = dq_part(saved["sim"] * (1 + 1e-6) / (saved["sim"] * (1 + 1e-6)).sum(-1, keepdim=True))
    rms = exact.pow(2).mean().sqrt()
    assert (scaled - exact).abs().max() > 1e-7 * rms
    assert (renorm - exact).abs().max() < 1e-3 * (scaled - exact).abs().max()


def test_block_totals_and_moments():
    """The stats grid's moments: float32 sums over a thread's tile of pairs,
    float64 over tiles and blocks, mu and the biased var = E[x^2] - mu^2 in
    float64, against the JAX kernel's moments (interpret mode) at 1e-5 and a
    float64 reference at 1e-6, on terms with nonzero means."""
    a, ks = _k7_inputs(2)
    a["q"] = a["q"] + 0.5
    a["k"] = a["k"] + 0.5
    t = {n: torch.from_numpy(x) for n, x in a.items()}
    f64 = _forward_saved(_f64(a), ks)
    terms32 = _forward_saved({n: x.float() for n, x in t.items()}, ks)["terms"]  # [3, N, g, L, L]
    r, length = k7.R_FWD[a["v"].shape[-1]], a["q"].shape[1]
    tiles = terms32.reshape(*terms32.shape[:3], length // r, r, length // r, r)
    s1 = tiles.sum(dim=(4, 6)).double().sum(dim=(1, 3, 4))            # [3, g]
    s2 = (tiles * tiles).sum(dim=(4, 6)).double().sum(dim=(1, 3, 4))
    m = float(np.prod(terms32.shape[1:])) / terms32.shape[2]
    mu = s1 / m
    var = s2 / m - mu * mu
    c, gp = a["q"].shape[-1], a["v"].shape[-1]
    rel = jnp.asarray(a["relative"])
    emb = rel[:, jnp.asarray(jax_relative_index(ks))].reshape(2 * gp, ks, ks)[:, :length, :length]
    j_mu, j_var, _ = jax_axial_train._moments(*(jnp.asarray(a[n]) for n in ("q", "k", "qg", "kg")),
                                              emb[:c], emb[c:gp].transpose(0, 2, 1), EPS, True)
    for got, ref, exact in ((mu, j_mu, f64["mu"]), (var, j_var, f64["var"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-6, atol=1e-7)


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


@pytest.mark.parametrize("rows,length,gp,units,warps,bwd_rows", [
    (1024, 128, 2, 8, 4, 16), (1024, 128, 4, 8, 4, 16), (512, 64, 8, 8, 4, 8),
    (256, 32, 16, 8, 4, 4), (37, 29, 4, 32, 4, 4),
    (64, 128, 32, 2, 1, 1),   # gp 32 at L = 128: two rows per fwd block, one warp per bwd block
])
def test_group_split(rows, length, gp, units, warps, bwd_rows):
    """The launch plan (it replaced the split of a row's groups over blocks):
    rows per stats/fwd block, one thread per query tile and within shared
    memory; bwd blocks of up to four warps, two an SM where they fit; every
    row of every group in exactly one block of each grid."""
    p = k7.plan(rows, length, 8, gp, max(length, 40))
    _, t_f = k7.fwd_tiles(length, gp)
    assert (p.units, p.warps, p.rows) == (units, warps, bwd_rows)
    assert p.units * t_f <= k7.THREADS and p.fwd_blocks == -(-rows // p.units)
    assert p.stats_blocks <= p.fwd_blocks and p.rows % p.warps == 0
    assert (p.bwd_blocks - 1) * p.rows < rows <= p.bwd_blocks * p.rows
    assert max(p.smem) <= 227 * 1024
    assert p.smem[2] == k7.bwd_smem(gp, length, p.warps)
    if p.warps > 1:
        assert p.smem[2] <= 113 * 1024


@pytest.mark.parametrize("rows,length,gp", [(1024, 128, 4), (37, 29, 4), (256, 128, 32)])
def test_plan_workspaces(rows, length, gp):
    """Each call's two workspaces: parts 256-byte aligned, in order, not
    overlapping, of the sizes the kernels index."""
    g, c = 8, gp // 2
    p = k7.plan(rows, length, g, gp, 128)
    want = {"consts": 9 * g, "stat": g * p.stats_blocks * 6, "rows": rows * g * length * 2,
            "svf": rows * g * length * 2 * gp, "e": 3 * g, "s_part": g * p.bwd_blocks * 3,
            "pi": rows * g * length * 4 * c, "pj": rows * g * length * 4 * c,
            "drel_part": g * p.bwd_blocks * (4 * c + gp) * (2 * length - 1)}
    for layout, total in ((p.fwd_ws, p.fwd_bytes), (p.bwd_ws, p.bwd_bytes)):
        end = 0
        for name, (off, count, dtype) in layout.items():
            assert count == want[name] and off % 256 == 0 and off >= end, name
            end = off + count * (8 if dtype == torch.float64 else 4)
        assert end <= total


@pytest.mark.parametrize("length,gp", [(5, 4), (16, 2), (29, 4), (32, 8), (32, 16), (64, 4),
                                       (128, 2), (128, 4), (128, 32)])
def test_band_walk_covers_every_pair_once(length, gp):
    """The bwd grid's walk (band_tiles): at every step the lanes hold one key
    tile and distinct query tiles (so per-query sums need no atomics and the
    per-key sums are one reduction); every pair (i, j) of the row lies in
    exactly one lane's tile; each lane stays on two bands, d and d - T."""
    r, t, loops = k7.bwd_tiles(length, gp)
    walk = k7.band_tiles(length, gp)
    assert t == 1 << (-(-length // r) - 1).bit_length() and loops == max(1, t // 32)
    seen = np.zeros((r * t, r * t), dtype=int)
    for j in range(t):
        rows_ = [i for d, jj, i, _ in walk if jj == j]
        assert sorted(rows_) == list(range(t))
    for d, j, i, band in walk:
        assert band == (d if j < t - d else d - t)
        seen[i * r:(i + 1) * r, j * r:(j + 1) * r] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("gp", [2, 4, 8])
def test_band_slots_hold_the_tile_diagonals(gp):
    """Within a tile of band D, pair (a, b) lies on offset i - j = R D + s -
    (R - 1) with slot s = a - b + R - 1 in [0, 2R - 1): the 2R - 1 diagonals a
    lane keeps in registers for the whole band (load_band, flush_band)."""
    length = 64
    r, _, _ = k7.bwd_tiles(length, gp)
    for d, j, i, band in k7.band_tiles(length, gp):
        for a in range(r):
            for b in range(r):
                s = a - b + r - 1
                assert 0 <= s < 2 * r - 1
                assert (i * r + a) - (j * r + b) == r * band + s - (r - 1)


@pytest.mark.parametrize("length,gp", [(5, 4), (29, 4), (64, 8), (32, 16), (128, 2)])
def test_forward_slots_read_their_offsets(length, gp):
    """The stats/fwd table of ``relative``: slot s of query tile t against key
    tile J reads the word load_rel_table stored the offset R (t - J) + s - (R - 1) at, for
    every tile and slot; the table's words are distinct per offset."""
    r, t = k7.fwd_tiles(length, gp)
    lp = r * t
    index = {o: k7.fwd_table_index(length, gp, o) for o in range(-(lp - 1), lp)}
    assert len(set(index.values())) == len(index) and max(index.values()) < 2 * lp
    for tt in range(t):
        for j in range(t):
            for s_ in range(2 * r - 1):
                o = r * (tt - j) + s_ - (r - 1)
                assert k7.fwd_slot_index(length, gp, tt, j, s_) == index[o]


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
