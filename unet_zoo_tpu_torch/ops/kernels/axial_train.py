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
float32 ``relative`` and gamma) a ``torch.autograd.Function`` runs the grids
of ``csrc/axial_train.cu``; each call allocates its outputs and one
workspace, and launches nothing else:

1. stats: the sums and sums of squares of qk, qr, kr (float64 from a tile
   of pairs on); the last block to finish forms mu, var and a on the device;
2. fwd: softmax and sv, sve, keeping each query row's max and 1 / Σ_j
   exp(logit - max), and float32 sv, sve, for the backward;
3. bwd (one pass): with sim = exp(logit - max) / sum from the saved row
   statistics and D_i = Σ_p dsv sv + dsve sve, dpre = sim (dsim - D_i); the partials of
   S_t = Σ dpre x̂_t; d_v and the v rows of d_relative; and, since
   BatchNorm's input gradient a dpre + e x̂ (e = -a S / M, M = N L²) is
   linear in e, two partials of each of d_q, d_k, d_qg, d_kg and the q and k
   rows of d_relative: Σ dpre·operand and Σ x̂·operand;
4. fin (one block): S, d_gamma = S and e;
5. combine: output = a (dpre part) + e (x̂ part) in bf16, and d_relative
   summed over the bwd blocks in a fixed order.

:func:`plan` sets every launch's geometry and the workspace (plain Python,
mirrored from the source); :func:`band_tiles` is the backward's tile walk.
mu, var, S, d_gamma and every bf16 output are deterministic; d_relative's
block partials come from float atomics and may differ between runs in the
last bits of float32. CPU tensors run :func:`fused_axial_train_reference`,
the plain version.

**In a data-parallel step** (``parallel.global_batch.data_group``) JAX's
GSPMD step takes both of K7's cross-sample sums over the global batch (XLA
forms them between the Pallas grids). A call there is split: the stats
grid writes its float64 sums, which are all-reduced over the group, and a
finishing launch (``stats_finish``) forms mu, var and a from them; fin
writes this rank's S (and d_gamma = that S, the rank's share of the
gradient the step averages), which is all-reduced before a second
finishing launch (``s_finish``) forms e = -a S / M over the global M. The
plain version sums the same moments over the group, differentiably.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from unet_zoo_tpu_torch.ops.kernels import build, refuse_export
from unet_zoo_tpu_torch.ops.kernels.axial_attention import relative_embeddings
from unet_zoo_tpu_torch.parallel.global_batch import data_group, global_moments

# Times the wrapper launched each grid (read by chip_smoke.py).
LAUNCHES = {"axial_train_stats": 0, "axial_train_fwd": 0, "axial_train_bwd": 0,
            "axial_train_fin": 0, "axial_train_combine": 0}
# and the two finishing grids of a split call (a data-parallel step)
FINISH_LAUNCHES = {"axial_train_stats_finish": 0, "axial_train_s_finish": 0}
_STATS, _FWD, _BWD, _FIN, _COMBINE, _STATS_FINISH, _S_FINISH = range(7)
_GRIDS = list(LAUNCHES) + list(FINISH_LAUNCHES)

GROUP_PLANES = (2, 4, 8, 16, 32)  # gp values the kernels are built for
MAX_LENGTH = 128                  # longest axis
THREADS = 256                     # stats, fwd, fin and combine blocks
MAX_WARPS = 4                     # bwd blocks
SMS = 132                         # the H100 SXM's multiprocessors
_SMEM_LIMIT = 227 * 1024 - 64     # a block's dynamic shared memory (static: the ticket flag)
_BWD_SMEM_PAIR = 113 * 1024       # two bwd blocks on an SM
# Rows of queries (and keys) a thread's tile holds, by gp: the most that keep
# the tile's operands, diagonals and sums in registers (r_fwd/r_bwd in the source).
R_FWD = {2: 4, 4: 4, 8: 2, 16: 1, 32: 1}
R_BWD = {2: 4, 4: 2, 8: 1, 16: 1, 32: 1}
# Order of the C interface's pointer and integer arguments (enum Ptr, enum Dim).
_PTRS = ("q", "k", "qg", "kg", "v", "dsv", "dsve", "relative", "gamma", "ticket", "mu", "var",
         "consts", "stat", "rows", "svf", "sv", "sve", "s_part", "e", "pi", "pj", "drel_part",
         "dq", "dk", "dqg", "dkg", "dv", "drel", "dgamma", "stat_sums", "s_sums")
_DIMS = ("n", "length", "ks", "groups", "gp", "rows", "blocks", "warps", "stats_blocks",
         "bwd_blocks", "split", "global_rows")
_PTR_INDEX = {name: i for i, name in enumerate(_PTRS)}


def fused_axial_train_reference(q, k, qg, kg, v, relative, gamma, kernel_size: int,
                                eps: float = 1e-5, group=None):
    """Plain PyTorch version of K7, same arguments: the train-mode module
    math (BatchNorm with its shift left out) in float32, differentiated by
    autograd. sv and sve come back in q's type, mu and var detached. With a
    ``group`` the moments are the global batch's: each rank's float64 sums
    summed over it (``parallel.global_batch.global_moments``)."""
    n, length, g, c = q.shape
    gp, dt = v.shape[-1], q.dtype
    q, k, qg, kg, v = (t.float() for t in (q, k, qg, kg, v))
    emb = relative_embeddings(relative.float(), kernel_size, length)
    q_emb, k_emb, v_emb = emb[:c], emb[c:gp], emb[gp:]
    qk = torch.einsum("nigc,njgc->nijg", q, k)
    qr = torch.einsum("nigc,cij->nijg", qg, q_emb)
    kr = torch.einsum("njgc,cji->nijg", kg, k_emb)
    stacked = torch.cat([qk, qr, kr], dim=-1)                   # [N, L, L, 3g]
    if group is None:
        var, mu = torch.var_mean(stacked, dim=(0, 1, 2), unbiased=False)
    else:
        mu, var, _ = global_moments(stacked, (0, 1, 2), group)
    y = (stacked - mu) * torch.rsqrt(var + eps) * gamma.reshape(-1).float()
    sim = torch.softmax(y.reshape(n, length, length, 3, g).sum(3), dim=2)
    sv = torch.einsum("nijg,njgp->nigp", sim, v)
    sve = torch.einsum("nijg,pij->nigp", sim, v_emb)
    return sv.to(dt), sve.to(dt), mu.reshape(3, g).detach(), var.reshape(3, g).detach()


# --- geometry (mirrors csrc/axial_train.cu) ----------------------------------------


def _ceil_div(x: int, y: int) -> int:
    return -(-x // y)


def _pow2_ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _round32(x: int) -> int:
    return (x + 31) & ~31


def fwd_tiles(length: int, gp: int) -> Tuple[int, int]:
    """(R, T) of the stats and fwd grids: R x R tiles, T = ceil(L / R) query
    tiles, one thread each."""
    r = R_FWD[gp]
    return r, _ceil_div(length, r)


def bwd_tiles(length: int, gp: int) -> Tuple[int, int, int]:
    """(R, T, loops) of the bwd grid: T, a power of two, tiles per side;
    a warp walks them in ``loops`` = T / 32 rounds of 32 lanes (1 when T <= 32)."""
    r = R_BWD[gp]
    t = _pow2_ceil(_ceil_div(length, r))
    return r, t, max(1, t // 32)


def fwd_smem(kind: int, gp: int, length: int, units: int) -> int:
    """Shared memory of a stats (kind 0) or fwd (1) block of ``units`` rows
    (``fwd_smem`` in the source): the diagonals of ``relative``, the units'
    operands, and the stats grid's per-thread float64 sums."""
    r, t = fwd_tiles(length, gp)
    lp, c = r * t, gp // 2
    nch, nrel = (4 * c, 2 * c) if kind == _STATS else (4 * c + gp, 2 * gp)
    floats = nrel * 2 * lp + units * (_round32(nch * lp) + (t & 31))
    return 4 * floats + (8 * THREADS * 6 if kind == _STATS else 0)


def bwd_smem(gp: int, length: int, warps: int) -> int:
    """Shared memory of a bwd block (``BwdGeom::smem``): the 2L - 1 columns of
    ``relative`` the offsets need; per warp, one row's operands in bf16
    [4C + 3gp][LP], its max, 1 / sum and D [3][LP], the sums over keys [R 4C][T]
    and over queries [R (4C + gp)][T + 1]; the warps' S sums."""
    r, t, _ = bwd_tiles(length, gp)
    c = gp // 2
    wstride = (_round32((4 * c + 3 * gp) * r * t // 2) + _round32(3 * r * t)
               + _round32(r * 4 * c * t) + _round32(r * (4 * c + gp) * (t + 1)))
    return (warps * wstride + _round32(2 * gp * (2 * length - 1))) * 4 + MAX_WARPS * 3 * 8


# The kernels' index math, copied for the CPU tests: no launch reads these.
# The source names each copy beside its original (load_rel_table, tile_slots,
# the bwd band walk); a change to one changes the other.
def fwd_table_index(length: int, gp: int, offset: int) -> int:
    """Where the stats/fwd grids keep ``relative``'s column of ``offset``
    o = i - j in a table row of 2 LP words (``load_rel_table``): o' = o + LP - 1
    at (o' mod R) 2T + o' div R, so that one slot of every thread's tile lies
    in consecutive words."""
    r, t = fwd_tiles(length, gp)
    op = offset + r * t - 1
    return (op % r) * 2 * t + op // r


def fwd_slot_index(length: int, gp: int, t: int, j: int, s: int) -> int:
    """The word slot s of query tile t against key tile J reads
    (``tile_slots``): offset R (t - J) + s - (R - 1)."""
    r, tt = fwd_tiles(length, gp)
    return (s % r) * 2 * tt + t - j + tt - 1 + s // r


def band_tiles(length: int, gp: int) -> List[Tuple[int, int, int, int]]:
    """The bwd grid's walk over one row's T x T tiles of R x R pairs, as
    (lane d, step J, query tile I, band D): lane d (of 32 per round) takes key
    tile J and query tile I = (J + d) mod T at step J, on band D = I - J, that
    is d while J < T - d and d - T after. Pair (I R + a, J R + b) of the tile
    lies on offset i - j = R D + s - (R - 1) with slot s = a - b + R - 1."""
    _, t, loops = bwd_tiles(length, gp)
    walk = []
    for d in range(min(t, 32 * loops)):
        for j in range(t):
            i = (j + d) % t
            walk.append((d, j, i, i - j))
    return walk


@dataclass(frozen=True)
class Plan:
    """One K7 call's launches and workspaces (:func:`plan`)."""

    units: int           # rows per stats/fwd block (one thread per query tile)
    fwd_blocks: int      # fwd blocks per group
    stats_blocks: int    # stats blocks per group (each walks several units' chunks)
    warps: int           # warps per bwd block (one row at a time each)
    rows: int            # rows per bwd block
    bwd_blocks: int      # bwd blocks per group
    elem_blocks: int     # combine blocks over d_q, d_k, d_qg, d_kg
    combine_blocks: int  # and over d_relative, 8 columns each
    smem: Tuple[int, int, int]                  # stats, fwd, bwd block bytes
    fwd_ws: Dict[str, Tuple[int, int, torch.dtype]]  # name -> (byte offset, count, dtype)
    bwd_ws: Dict[str, Tuple[int, int, torch.dtype]]
    fwd_bytes: int
    bwd_bytes: int
    dims: Dict[int, ctypes.Array]   # the C interface's integers, by grid


def _layout(parts):
    out, off = {}, 0
    for name, count, dtype in parts:
        out[name] = (off, count, dtype)
        off += (count * (8 if dtype == torch.float64 else 4) + 255) // 256 * 256
    return out, off


@functools.lru_cache(maxsize=64)
def plan(n: int, length: int, groups: int, gp: int, kernel_size: int, split: bool = False,
         world: int = 1) -> Plan:
    """Launch geometry and workspaces for N rows of length L, g groups of gp
    channels: stats/fwd blocks of up to 256 / T rows that fit shared memory,
    stats blocks near two waves of the card, bwd blocks of up to four warps
    (two blocks an SM where they fit) near four waves. A ``split`` call (a
    data-parallel step over ``world`` ranks of N rows each) adds the float64
    sums that are all-reduced between grids to each workspace."""
    c = gp // 2
    _, t_f = fwd_tiles(length, gp)
    units = max(1, min(THREADS // t_f, n))
    while units > 1 and fwd_smem(_FWD, gp, length, units) > _SMEM_LIMIT:
        units -= 1
    smem_f = fwd_smem(_FWD, gp, length, units)
    smem_s = fwd_smem(_STATS, gp, length, units)
    if max(smem_f, smem_s) > _SMEM_LIMIT:
        raise ValueError(f"the K7 kernel does not fit an axis of {length} with gp={gp} in "
                         f"shared memory; use_kernels=False trains such a model on its module path")
    fwd_blocks = _ceil_div(n, units)
    stats_blocks = min(fwd_blocks, _ceil_div(2 * SMS, groups))
    warps = next((w for w in (4, 2, 1) if bwd_smem(gp, length, w) <= _BWD_SMEM_PAIR), 1)
    if bwd_smem(gp, length, warps) > _SMEM_LIMIT:
        raise ValueError(f"the K7 backward does not fit an axis of {length} with gp={gp} in "
                         f"shared memory; use_kernels=False trains such a model on its module path")
    rows = max(warps, _ceil_div(n, _ceil_div(4 * SMS, groups)))
    rows = _ceil_div(rows, warps) * warps
    bwd_blocks = _ceil_div(n, rows)
    elem_blocks = max(1, min(_ceil_div(n * length * groups * c, THREADS), 4 * SMS))
    combine_blocks = elem_blocks + 2 * gp * _ceil_div(2 * kernel_size - 1, 8)
    f32, f64 = torch.float32, torch.float64
    fwd_ws, fwd_bytes = _layout([("consts", 9 * groups, f32),
                                 ("stat", groups * stats_blocks * 6, f64),
                                 ("rows", n * groups * length * 2, f32),
                                 ("svf", n * groups * length * 2 * gp, f32)]
                                + [("stat_sums", 6 * groups, f64)] * split)
    bwd_ws, bwd_bytes = _layout([("e", 3 * groups, f32),
                                 ("s_part", groups * bwd_blocks * 3, f64),
                                 ("pi", n * groups * length * 4 * c, f32),
                                 ("pj", n * groups * length * 4 * c, f32),
                                 ("drel_part",
                                  groups * bwd_blocks * (4 * c + gp) * (2 * length - 1), f32)]
                                + [("s_sums", 3 * groups, f64)] * split)
    dims = {}
    for kind, (per, blocks) in {_STATS: (units, stats_blocks), _FWD: (units, fwd_blocks),
                                _BWD: (rows, bwd_blocks), _FIN: (0, 1),
                                _COMBINE: (elem_blocks, combine_blocks),
                                _STATS_FINISH: (0, 1), _S_FINISH: (0, 1)}.items():
        dims[kind] = (ctypes.c_int * len(_DIMS))(n, length, kernel_size, groups, gp, per, blocks,
                                                 warps, stats_blocks, bwd_blocks, int(split),
                                                 n * world)
    return Plan(units, fwd_blocks, stats_blocks, warps, rows, bwd_blocks, elem_blocks,
                combine_blocks, (smem_s, smem_f, bwd_smem(gp, length, warps)), fwd_ws, bwd_ws,
                fwd_bytes, bwd_bytes, dims)


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
        lib.axial_train.argtypes = [i, p, p, p, ctypes.c_float, p]
        lib.axial_train.restype = i
        lib.axial_train_smem.argtypes = [i, i, i, i]
        lib.axial_train_smem.restype = ctypes.c_longlong
        lib._typed = True
    return lib


_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The stats grid's counter of finished blocks for launches on ``stream``
    of ``device``: zeroed once; the last block of every launch sets it back
    to 0. Launches on one stream run one after another, so each stream keeps
    its own counter and calls on two streams never share one."""
    t = _TICKETS.get((device, stream))
    if t is None:
        t = _TICKETS[device, stream] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


class _Call:
    """One K7 call's launch arguments: the tensors by name, the plan, its
    workspaces (:meth:`view` reads a workspace part) and the C interface's
    pointer and stride arrays, built once for the call's grids."""

    def __init__(self, tensors, plan_, eps, stream, workspaces):
        self.tensors, self.plan, self.eps, self.stream = tensors, plan_, eps, stream
        self.ws = workspaces
        ptrs, strides = [None] * len(_PTRS), [0] * 21
        for name, t in tensors.items():
            if t is not None:
                w = _PTR_INDEX[name]
                ptrs[w] = t.data_ptr()
                if w < 7:
                    strides[3 * w:3 * w + 3] = t.stride()[:3]
        for which, ws in workspaces.items():
            base = ws.data_ptr()
            for name, (off, _, _) in (plan_.fwd_ws if which == "fwd" else plan_.bwd_ws).items():
                ptrs[_PTR_INDEX[name]] = base + off
        self.args = ((ctypes.c_void_p * len(_PTRS))(*ptrs), (ctypes.c_longlong * 21)(*strides))

    @property
    def dims(self) -> Dict[str, int]:
        return dict(zip(_DIMS, self.plan.dims[_FWD]))

    def view(self, name: str) -> torch.Tensor:
        for which, layout in (("fwd", self.plan.fwd_ws), ("bwd", self.plan.bwd_ws)):
            if name in layout and which in self.ws:
                off, count, dtype = layout[name]
                size = 8 if dtype == torch.float64 else 4
                return self.ws[which][off:off + count * size].view(dtype)
        raise KeyError(name)


def _launch(kind: int, call: _Call) -> None:
    err = _lib().axial_train(kind, *call.args, call.plan.dims[kind], call.eps, call.stream)
    if err:
        raise RuntimeError(f"{_GRIDS[kind]} launch failed: cudaError {err}")
    (LAUNCHES if kind < _STATS_FINISH else FINISH_LAUNCHES)[_GRIDS[kind]] += 1


# One function per grid: chip_smoke.py and the card tests plant faults by
# wrapping them.
def _stats(call: _Call) -> None:
    _launch(_STATS, call)


def _forward(call: _Call) -> None:
    _launch(_FWD, call)


def _backward_pass(call: _Call) -> None:
    _launch(_BWD, call)


def _finish(call: _Call) -> None:
    _launch(_FIN, call)


def _combine(call: _Call) -> None:
    _launch(_COMBINE, call)


def _stats_finish(call: _Call) -> None:
    _launch(_STATS_FINISH, call)


def _s_finish(call: _Call) -> None:
    _launch(_S_FINISH, call)


class _FusedAxialTrain(torch.autograd.Function):
    """K7's grids; see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, qg, kg, v, relative, gamma, kernel_size, eps, group):
        n, length, g, gp = _check_kernel_args(q, k, qg, kg, v, relative, gamma, kernel_size)
        split = group is not None
        world = torch.distributed.get_world_size(group) if split else 1
        plan_ = plan(n, length, g, gp, kernel_size, split, world)
        dev = q.device
        with torch.cuda.device(dev):
            sv = torch.empty(n, length, g, gp, dtype=q.dtype, device=dev)
            sve = torch.empty_like(sv)
            mu = torch.empty(3, g, dtype=torch.float32, device=dev)
            var = torch.empty_like(mu)
            ws = torch.empty(plan_.fwd_bytes, dtype=torch.uint8, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            call = _Call(dict(q=q, k=k, qg=qg, kg=kg, v=v, relative=relative, gamma=gamma,
                              ticket=_ticket(dev, stream), mu=mu, var=var, sv=sv, sve=sve),
                         plan_, eps, stream, {"fwd": ws})
            _stats(call)
            if split:
                torch.distributed.all_reduce(call.view("stat_sums"), group=group)
                _stats_finish(call)
            _forward(call)
        ctx.save_for_backward(q, k, qg, kg, v, relative, gamma, ws)
        ctx.meta = (n, length, g, gp, eps, plan_, group, split)
        ctx.mark_non_differentiable(mu, var)
        ctx.set_materialize_grads(False)
        return sv, sve, mu, var

    @staticmethod
    def backward(ctx, d_sv, d_sve, _d_mu, _d_var):
        q, k, qg, kg, v, relative, gamma, ws = ctx.saved_tensors
        n, length, g, gp, eps, plan_, group, split = ctx.meta
        c, dev = gp // 2, q.device
        if d_sv is not None and (d_sv.dtype != q.dtype or d_sv.stride(-1) != 1):
            d_sv = d_sv.to(q.dtype).contiguous()     # autograd hands in q's type, channels last
        if d_sve is not None and (d_sve.dtype != q.dtype or d_sve.stride(-1) != 1):
            d_sve = d_sve.to(q.dtype).contiguous()
        with torch.cuda.device(dev):
            grads = [torch.empty(n, length, g, c, dtype=q.dtype, device=dev) for _ in range(4)]
            d_v = torch.empty(n, length, g, gp, dtype=q.dtype, device=dev)
            d_rel = torch.empty_like(relative)
            d_gamma = torch.empty_like(gamma)
            ws_b = torch.empty(plan_.bwd_bytes, dtype=torch.uint8, device=dev)
            call = _Call(dict(q=q, k=k, qg=qg, kg=kg, v=v, dsv=d_sv, dsve=d_sve,
                              relative=relative, gamma=gamma, dq=grads[0], dk=grads[1],
                              dqg=grads[2], dkg=grads[3], dv=d_v, drel=d_rel, dgamma=d_gamma),
                         plan_, eps, torch.cuda.current_stream(dev).cuda_stream,
                         {"fwd": ws, "bwd": ws_b})
            _backward_pass(call)
            _finish(call)
            if split:
                torch.distributed.all_reduce(call.view("s_sums"), group=group)
                _s_finish(call)
            _combine(call)
        d_q, d_k, d_qg, d_kg = grads
        return d_q, d_k, d_qg, d_kg, d_v, d_rel, d_gamma, None, None, None


def fused_axial_train(q, k, qg, kg, v, relative, gamma, kernel_size: int, eps: float = 1e-5):
    """One axis pass of MedT attention in training: (sv, sve, mu, var).

    Arguments as the module docstring's contract. CUDA tensors run the
    kernels through a ``torch.autograd.Function`` (anything they do not take
    raises); CPU tensors run :func:`fused_axial_train_reference`. Inside a
    data-parallel step (a data group, even of one rank) the moments and S
    are the global batch's: a split call.
    """
    refuse_export("K7 (fused_axial_train)", q)
    group = data_group()
    if q.device.type == "cpu":
        return fused_axial_train_reference(q, k, qg, kg, v, relative, gamma, kernel_size, eps,
                                           group)
    if q.device.type != "cuda":
        raise ValueError(f"fused_axial_train runs on cuda or cpu, not {q.device}")
    return _FusedAxialTrain.apply(q, k, qg, kg, v, relative, gamma, kernel_size, eps, group)
