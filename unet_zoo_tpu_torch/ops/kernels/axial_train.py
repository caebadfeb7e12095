"""K7: MedT axial attention in training, with batch-statistics BatchNorm
on the similarity and exact gradients.

For each row n of an axis pass, group g, query i and key j, the three raw
similarity terms are

    qk[n,g,i,j] = Σ_c q[n,i,g,c] k[n,j,g,c]
    qr[n,g,i,j] = Σ_c qg[n,i,g,c] q_emb[c,i,j]
    kr[n,g,i,j] = Σ_c kg[n,j,g,c] k_emb[c,j,i]

(``qg``/``kg`` carry the ``gated`` variant's f_qr/f_kr; pass q/k in
``base``). Their batch moments over (n, i, j), per term t and group,
are mu and the biased var; with a = gamma·rsqrt(var + eps),

    sim = softmax_j(a_qk qk + a_qr qr + a_kr kr)
    sv[n,i,g,p] = Σ_j sim v[n,j,g,p],   sve[n,i,g,p] = Σ_j sim v_emb[p,i,j].

BatchNorm's shift (mu, beta) is constant over j and leaves the softmax:
it adds nothing to the outputs and its gradient is exactly zero. Counterpart
of ``unet_zoo_tpu/ops/pallas/axial_train.py::fused_axial_train``.

**Contract.** As the JAX function, except for the embeddings: this port
takes ``relative`` [2gp, 2ks - 1] (rows q | k | v) and indexes it as K6 does,
``emb[c,a,b] = relative[c, a - b + ks - 1]`` cut to L (the ks - 1 offset
holds when L < ks), where the JAX function takes the tables q_emb, keT,
v_emb. q, k, qg, kg [N, L, g, gp/2] and v [N, L, g, gp] (channels
contiguous, other strides free: the module hands in slices of the qkv
projection); gamma [3, g] is ``bn_similarity``'s scale, term-major. Returns
(sv, sve, mu, var): sv, sve [N, L, g, gp] in q's type, mu and var [3, g]
float32, for the caller's running-statistics update; they carry no
gradient. The gradient of gamma is S (below); ``relative``'s gradient sums
the table gradients along their diagonals.

**On the card** (:func:`fused_axial_train` on CUDA tensors, bf16 q/k/qg/kg/v,
float32 ``relative`` and gamma) a ``torch.autograd.Function`` runs four
grids of ``csrc/axial_train.cu``, each recomputing the similarity from the
row's operands with one device function:

1. stats: per block, the sums and sums of squares of qk, qr, kr, in float64;
   the wrapper sums the blocks in float64 (on the device, no host sync),
   forms mu and var = E[x²] - mu² in float64, then a;
2. forward: softmax and sv, sve;
3. B1 (backward): dpre = sim (dsim - Σ_j dsim sim), the partials of
   S_t = Σ dpre x̂_t over (i, j) in float64, d_v and the v rows of
   d_relative;
4. B2: with e = -a S / M (M = N L²), dtot_t = a_t dpre + e_t x̂_t, the exact
   gradient of each raw term (the mean term vanishes because every row of
   dpre sums to zero), contracted into d_q, d_k, d_qg, d_kg and the q and k
   rows of d_relative.

Sums over keys j stay in a warp; sums over queries i (d_v, d_k, d_kg) stay
in registers over a warp's queries and add into shared memory once per
warp and group, sums over diagonals (d_relative) per query, with atomics; blocks
write their own partial of d_relative and the wrapper sums the partials
over blocks in a fixed order. So mu, var, S and d_gamma are deterministic,
while the results of shared-memory atomics may differ between runs in the
last bits of float32. CPU tensors run :func:`fused_axial_train_reference`,
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from unet_zoo_tpu_torch.ops.kernels import build
from unet_zoo_tpu_torch.ops.kernels.axial_attention import relative_embeddings, split_groups

# Times the wrapper launched each grid (read by chip_smoke.py).
LAUNCHES = {"axial_train_stats": 0, "axial_train_fwd": 0, "axial_train_b1": 0,
            "axial_train_b2": 0}
_STATS, _FWD, _B1, _B2 = 0, 1, 2, 3
_GRIDS = list(LAUNCHES)

GROUP_PLANES = (2, 4, 8, 16, 32)  # gp values the kernels are built for
MAX_LENGTH = 128                  # longest axis: 4 keys per lane of a warp
_NWARPS = 8                       # warps of a block (NTHREADS / 32 in the source)


def fused_axial_train_reference(q, k, qg, kg, v, relative, gamma, kernel_size: int,
                                eps: float = 1e-5):
    """Plain PyTorch version of K7, same arguments: the train-mode module
    math (BatchNorm with its shift left out) in float32, differentiated by
    autograd. sv and sve come back in q's type, mu and var detached."""
    n, length, g, c = q.shape
    gp, dt = v.shape[-1], q.dtype
    q, k, qg, kg, v = (t.float() for t in (q, k, qg, kg, v))
    emb = relative_embeddings(relative.float(), kernel_size, length)
    q_emb, k_emb, v_emb = emb[:c], emb[c:gp], emb[gp:]
    qk = torch.einsum("nigc,njgc->nijg", q, k)
    qr = torch.einsum("nigc,cij->nijg", qg, q_emb)
    kr = torch.einsum("njgc,cji->nijg", kg, k_emb)
    stacked = torch.cat([qk, qr, kr], dim=-1)                   # [N, L, L, 3g]
    var, mu = torch.var_mean(stacked, dim=(0, 1, 2), unbiased=False)
    y = (stacked - mu) * torch.rsqrt(var + eps) * gamma.reshape(-1).float()
    sim = torch.softmax(y.reshape(n, length, length, 3, g).sum(3), dim=2)
    sv = torch.einsum("nijg,njgp->nigp", sim, v)
    sve = torch.einsum("nijg,pij->nigp", sim, v_emb)
    return sv.to(dt), sve.to(dt), mu.reshape(3, g).detach(), var.reshape(3, g).detach()


def _smem_bytes(kind: int, length: int, gb: int, gp: int) -> int:
    """Shared memory of one block of grid ``kind`` (``smem_bytes`` in
    csrc/axial_train.cu)."""
    c, rl = gp // 2, 2 * length - 1
    ch = {_STATS: 2 * gp, _FWD: 3 * gp, _B1: 5 * gp, _B2: 5 * gp}[kind]
    floats = length * (gb * ch + 1) + 2 * gp * rl + 12 * gb
    doubles = _NWARPS * gb * {_STATS: 6, _FWD: 0, _B1: 3, _B2: 0}[kind]
    if kind == _B1:
        floats += (length | 1) * gb * gp + gp * rl
    elif kind == _B2:
        floats += 2 * (length | 1) * gb * c + 2 * c * rl
    return 8 * doubles + 4 * floats


def group_split(rows: int, groups: int, length: int, gp: int) -> int:
    """Blocks per row, as K6 chooses them, with K7's largest grid's shared
    memory."""
    return split_groups(rows, groups, lambda gb: max(_smem_bytes(kind, length, gb, gp)
                                                     for kind in range(4)),
                        "K7", length, gp)


def _check_kernel_args(q, k, qg, kg, v, relative, gamma, kernel_size):
    if q.dim() != 4:
        raise ValueError(f"q must be [N, L, g, gp/2], got {tuple(q.shape)}")
    n, length, g, c = q.shape
    gp = 2 * c
    for name, t in (("k", k), ("qg", qg), ("kg", kg), ("v", v)):
        want = (n, length, g, gp if name == "v" else c)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want}")
    for name, t in (("q", q), ("k", k), ("qg", qg), ("kg", kg), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have contiguous channels")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if gp not in GROUP_PLANES:
        raise ValueError(f"the K7 kernel takes group widths gp in {GROUP_PLANES}, not {gp}; "
                         f"use_kernels=False trains such a model on its module path")
    if length > MAX_LENGTH:
        raise ValueError(f"the K7 kernel takes axes up to {MAX_LENGTH}, not {length}; "
                         f"use_kernels=False trains such a model on its module path")
    if length > kernel_size:
        raise ValueError(f"axis length {length} exceeds the kernel size {kernel_size}")
    for name, t, want in (("relative", relative, (2 * gp, 2 * kernel_size - 1)),
                          ("gamma", gamma, (3, g))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n * length * g * 2 * gp >= 2**31:
        raise ValueError("tensors above 2^31 elements are not supported")
    return n, length, g, gp


def _lib():
    lib = build.library("axial_train")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.axial_train.argtypes = [i, p, p, i, i, i, i, i, i, p]
        lib.axial_train.restype = i
        lib._typed = True
    return lib


def _launch(kind: int, operands, outputs, dims) -> None:
    """One grid: ``operands`` (q, k, qg, kg, v, dsv, dsve, relative, consts;
    None where the grid reads none), ``outputs`` (up to five), ``dims``
    (N, L, ks, g, gp, split)."""
    q = operands[0]
    ptrs = [None if t is None else t.data_ptr() for t in operands]
    ptrs += [t.data_ptr() for t in outputs] + [None] * (5 - len(outputs))
    strides = [s for t in operands[:5] for s in t.stride()[:3]]
    n, length, ks, g, gp, split = dims
    err = _lib().axial_train(kind, (ctypes.c_void_p * 14)(*ptrs),
                             (ctypes.c_longlong * 15)(*strides), n, length, ks, g, gp, split,
                             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{_GRIDS[kind]} launch failed: cudaError {err}")
    LAUNCHES[_GRIDS[kind]] += 1


def _group_totals(partial: torch.Tensor) -> torch.Tensor:
    """Per-block sums [N, split, R, g / split] -> totals [R, g], in float64."""
    tot = partial.sum(0, dtype=torch.float64)                   # [split, R, gb]
    return tot.transpose(0, 1).reshape(tot.shape[1], -1)


def _moments(sums: torch.Tensor, m: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float64 sums [6, g] of the terms and their squares -> mu, biased var
    (float32 [3, g])."""
    mu = sums[:3] / m
    return mu.float(), (sums[3:] / m - mu * mu).float()


def _e_term(a: torch.Tensor, s: torch.Tensor, m: float) -> torch.Tensor:
    """e = -a S / M, the x̂ coefficient of BatchNorm's input gradient."""
    return (-(a.double() * s) / m).float()


def _sum_blocks(partial: torch.Tensor) -> torch.Tensor:
    """Per-block partials of d_relative's rows [blocks, rows, 2L - 1] -> their sum."""
    return partial.sum(0)


class _FusedAxialTrain(torch.autograd.Function):
    """K7's four grids; see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, qg, kg, v, relative, gamma, kernel_size, eps):
        n, length, g, gp = _check_kernel_args(q, k, qg, kg, v, relative, gamma, kernel_size)
        split = group_split(n, g, length, gp)
        dims = (n, length, kernel_size, g, gp, split)
        m = float(n * length * length)
        with torch.cuda.device(q.device):
            part = torch.empty(n, split, 6, g // split, dtype=torch.float64, device=q.device)
            _launch(_STATS, (q, k, qg, kg, v, None, None, relative, None), (part,), dims)
            mu, var = _moments(_group_totals(part), m)
            inv = torch.rsqrt(var + eps)
            consts = torch.stack([gamma * inv, mu, inv, torch.zeros_like(mu)]).contiguous()
            sv = torch.empty(n, length, g, gp, dtype=q.dtype, device=q.device)
            sve = torch.empty_like(sv)
            _launch(_FWD, (q, k, qg, kg, v, None, None, relative, consts), (sv, sve), dims)
        ctx.save_for_backward(q, k, qg, kg, v, relative, consts)
        ctx.dims, ctx.m = dims, m
        ctx.mark_non_differentiable(mu, var)
        return sv, sve, mu, var

    @staticmethod
    def backward(ctx, d_sv, d_sve, _d_mu, _d_var):
        q, k, qg, kg, v, relative, consts = ctx.saved_tensors
        n, length, ks, g, gp, split = ctx.dims
        c, rl = gp // 2, 2 * length - 1
        grad_in = [torch.zeros(n, length, g, gp, dtype=q.dtype, device=q.device)
                   if d is None else d.to(q.dtype).contiguous() for d in (d_sv, d_sve)]
        ops = (q, k, qg, kg, v, *grad_in, relative, consts)
        with torch.cuda.device(q.device):
            s_part = torch.empty(n, split, 3, g // split, dtype=torch.float64, device=q.device)
            d_v = torch.empty(n, length, g, gp, dtype=q.dtype, device=q.device)
            rel_v = torch.empty(n * split, gp, rl, dtype=torch.float32, device=q.device)
            _launch(_B1, ops, (s_part, d_v, rel_v), ctx.dims)
            s = _group_totals(s_part)                                    # [3, g]
            consts = torch.cat([consts[:3], _e_term(consts[0], s, ctx.m)[None]]).contiguous()
            grads = [torch.empty(n, length, g, c, dtype=q.dtype, device=q.device)
                     for _ in range(4)]
            rel_qk = torch.empty(n * split, gp, rl, dtype=torch.float32, device=q.device)
            _launch(_B2, ops[:8] + (consts,), (*grads, rel_qk), ctx.dims)
            d_rel = torch.zeros_like(relative)
            cols = slice(ks - length, ks + length - 1)
            d_rel[:gp, cols] = _sum_blocks(rel_qk)
            d_rel[gp:, cols] = _sum_blocks(rel_v)
        d_q, d_k, d_qg, d_kg = grads
        return d_q, d_k, d_qg, d_kg, d_v, d_rel, s.float(), None, None


def fused_axial_train(q, k, qg, kg, v, relative, gamma, kernel_size: int, eps: float = 1e-5):
    """One axis pass of MedT attention in training: (sv, sve, mu, var).

    Arguments as the module docstring's contract. CUDA tensors run the four
    grids through a ``torch.autograd.Function`` (anything the kernels do not
    take raises); CPU tensors run :func:`fused_axial_train_reference`.
    """
    if q.device.type == "cpu":
        return fused_axial_train_reference(q, k, qg, kg, v, relative, gamma, kernel_size, eps)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_train runs on cuda or cpu, not {q.device}")
    return _FusedAxialTrain.apply(q, k, qg, kg, v, relative, gamma, kernel_size, eps)
