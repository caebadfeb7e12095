"""K6's host-side plan and the kernel's order of arithmetic (CPU).

The CUDA kernel (``csrc/axial_attention.cu``) gives each lane R query rows
of one (row, group) and walks the keys in tiles of R with an online softmax
in log2 units and a lazy rescale; lanes left over by a short axis split the
keys and merge their partials. The wrapper plans the launch in plain Python
(``ops/kernels/axial_attention.py::plan``), so the plan is checked here, and
:func:`emulate` repeats the kernel's order of operations in PyTorch to hold
it against ``fused_axial_attention_reference``. ``tests/test_torch_kernels_cuda.py``
holds the plan's shared memory against the built source, on the card.
"""

import math

import numpy as np
import pytest
import torch

from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
MARGIN = 8.0   # csrc/axial_attention.cu
# gated (s = 0.125, groups 8) at B=8/256px: (L = H = W, gp, ks, rows N)
SERVED = [(128, 2, 128, 1024), (128, 4, 128, 1024), (64, 4, 64, 512), (64, 8, 64, 512),
          (32, 8, 32, 256), (32, 16, 32, 256)]
LENGTHS = [1, 2, 29, 31, 32, 33, 63, 64, 65, 127, 128, 129, 250, 256, 300, 512]


def parent_took(length, gp, wopos):
    """Whether the previous K6 kernel (one block of one group at least,
    within its 200 KB) took the shape."""
    rel = 0 if wopos else 2 * gp * (2 * length - 1)
    return 4 * (length * (2 * gp + 1) + rel + 3 + 3 * gp) <= 200 * 1024


def coverage(p, length):
    """How often the plan's lanes take each (query, key) pair of one (row,
    group), and how often each query row is written, following the
    kernel's index arithmetic."""
    r, t_all = p.rows_per_lane, p.tiles
    pairs = np.zeros((t_all * r, t_all * r), np.int32)
    writes = np.zeros(t_all * r, np.int32)
    for wq in range(p.warps):
        for lane in range(32):
            split, tl = divmod(lane, p.lanes)
            for chunk in range(wq, p.chunks, p.warps):
                t = chunk * 32 + tl
                if t >= t_all or split >= p.splits:
                    continue
                j0, j1 = split * t_all // p.splits, (split + 1) * t_all // p.splits
                assert j1 > j0                   # every split has a key tile
                pairs[t * r:(t + 1) * r, j0 * r:j1 * r] += 1
                if split == 0:
                    writes[t * r:(t + 1) * r] += 1
    return pairs[:length, :length], writes[:length]


def check_plan(rows, groups, length, gp, wopos):
    p = k6.plan(rows, groups, length, gp, wopos)
    assert p.rows_per_lane == k6.rows_per_lane(gp)
    assert p.tiles * p.rows_per_lane >= length > (p.tiles - 1) * p.rows_per_lane
    assert p.lanes * p.splits <= 32 and p.splits & (p.splits - 1) == 0
    assert groups % p.groups_per_block == 0
    assert p.grid == (rows, groups // p.groups_per_block)
    assert p.threads == 32 * p.groups_per_block * p.warps <= 32 * k6.MAX_WARPS
    assert p.smem == k6.smem_bytes(length, gp, p.groups_per_block, wopos) <= k6.SMEM_LIMIT
    pairs, writes = coverage(p, length)
    assert (pairs == 1).all() and (writes == 1).all()
    return p


@pytest.mark.parametrize("length,gp,ks,rows", SERVED)
def test_served_plans(length, gp, ks, rows):
    """Each served launch: rows and keys covered once, within shared memory,
    and at least TARGET_BLOCKS blocks of whole warps."""
    for wopos in (False, True):
        p = check_plan(rows, 8, length, gp, wopos)
        assert p.grid[0] * p.grid[1] >= k6.TARGET_BLOCKS
        assert p.lanes * p.splits == 32


@pytest.mark.parametrize("gp", k6.GROUP_PLANES)
def test_plan_takes_every_shape_the_previous_kernel_took(gp):
    """Every gp x length x mode, at 1, 3 and 8 groups: the plan covers every
    pair once within shared memory; it refuses only gp 32 at L = 512 with
    positions (the 2 gp x 2 L columns of ``relative`` alone exceed it), with
    the message the previous plan gave."""
    for length in LENGTHS:
        for wopos in (False, True):
            for groups in (1, 3, 8):
                rows = 2 * length + 1
                if gp == 32 and length == 512 and not wopos:
                    assert not parent_took(length, gp, wopos)
                    with pytest.raises(ValueError, match="shared memory; use_kernels=False"):
                        k6.plan(rows, groups, length, gp, wopos)
                    continue
                check_plan(rows, groups, length, gp, wopos)


# The previous plan's group-split cases (rows, L, gp, its split), each now a
# case of the new plan at 8 groups.
@pytest.mark.parametrize("rows,length,gp,split", [
    (1024, 128, 2, 2), (512, 64, 4, 4), (256, 32, 16, 8), (37, 29, 4, 8),
    (4096, 256, 16, 2),
    (2048, 256, 32, 8),
])
def test_plan_at_former_group_split_shapes(rows, length, gp, split):
    p = check_plan(rows, 8, length, gp, False)
    # the grid has at least the previous one's blocks where that one reached
    # TARGET_BLOCKS
    if rows * split >= k6.TARGET_BLOCKS:
        assert p.grid[0] * p.grid[1] >= k6.TARGET_BLOCKS


def test_plan_raises_only_when_nothing_fits():
    assert k6.plan(64, 8, 512, 32, True).groups_per_block == 1   # wopos: no relative columns
    with pytest.raises(ValueError, match="shared memory"):
        k6.plan(64, 8, 512, 32, False)


def test_plan_is_cached():
    assert k6.plan(1024, 8, 128, 4, False) is k6.plan(1024, 8, 128, 4, False)


# --- the kernel's order of arithmetic -----------------------------------------------------


def _toeplitz(table, length, lp, ks, reverse=False):
    """[rows, lp, lp] of ``table[r, ±(i - j) + ks - 1]`` for |i - j| < length,
    else 0: the values the kernel's staged columns give pair (i, j)."""
    i = torch.arange(lp)[:, None]
    o = i - torch.arange(lp)[None, :]
    idx = (-o if reverse else o) + ks - 1
    ok = o.abs() < length
    vals = table[:, idx.clamp(0, table.shape[1] - 1)]
    return torch.where(ok, vals, torch.zeros(()))


def emulate(qkv, relative, sim_scale, out_scale, out_shift, ks, width_axis, fault=None):
    """K6 in the kernel's order (f32): the plan's tiles and key splits, one
    online softmax in log2 units with the lazy rescale, the splits' merge
    by the xor tree. ``fault`` plants one of ``k6.FAULTS`` as the source's
    fault entry does. Returns (output like the reference's, rescales)."""
    b = qkv.shape[0]
    g, gp = out_scale.shape[1], out_scale.shape[2]
    c = gp // 2
    x = k6.axis_rows(qkv.float(), width_axis)
    n, length = x.shape[0], x.shape[1]
    p = k6.plan(n, g, length, gp, relative is None)
    r, t_all = p.rows_per_lane, p.tiles
    lp = t_all * r
    x = torch.nn.functional.pad(x.reshape(n, length, g, 2 * gp), (0, 0, 0, 0, 0, lp - length))
    x = x.permute(0, 2, 1, 3)                                # [N, g, LP, 2 gp]
    q, k, v = x[..., :c], x[..., c:gp], x[..., gp:]
    scale = sim_scale.float() * LOG2E
    qa = q * scale[0][:, None, None]
    qb = q * scale[1][:, None, None]
    kk = k * scale[2][:, None, None]
    logit = torch.einsum("ngic,ngjc->ngij", qa, k)
    if relative is not None:
        rq = _toeplitz(relative[:c].float(), length, lp, ks)
        rk = _toeplitz(relative[c:gp].float(), length, lp, ks, reverse=True)
        rv = _toeplitz(relative[gp:].float(), length, lp, ks)
        logit = (logit + torch.einsum("ngic,cij->ngij", qb, rq)
                 + torch.einsum("ngjc,cij->ngij", kk, rk))
    logit[..., length:] = -math.inf
    drop_last = fault == "partial key tile dropped" and length % r
    parts, rescales = [], 0
    for split in range(p.splits):
        j0, j1 = split * t_all // p.splits, (split + 1) * t_all // p.splits
        if drop_last and j1 == t_all:
            j1 -= 1
        m = torch.zeros(n, g, lp)
        s = torch.zeros(n, g, lp)
        acc = torch.zeros(n, g, lp, gp)
        acce = torch.zeros(n, g, lp, gp)
        for jt in range(j0, j1):
            keys = slice(jt * r, (jt + 1) * r)
            xt = logit[..., keys] - m[..., None]
            top = xt.max(-1).values
            move = (top > MARGIN) | (jt == j0)
            rescales += int((move & (jt != j0)).sum())
            f = torch.where(move & (jt != j0) & (fault != "rescale skipped"),
                            torch.exp2(-top), torch.ones(()))
            s, acc, acce = s * f, acc * f[..., None], acce * f[..., None]
            m = m + torch.where(move, top, torch.zeros(()))
            e = torch.exp2(xt - torch.where(move, top, torch.zeros(()))[..., None])
            s = s + e.sum(-1)
            acc = acc + torch.einsum("ngij,ngjp->ngip", e, v[:, :, keys])
            if relative is not None:
                acce = acce + torch.einsum("ngij,pij->ngip", e, rv[:, :, keys])
        parts.append((m, s, acc, acce))
    step = 1
    while step < p.splits and fault != "key-split merge dropped":
        merged = []
        for a in range(p.splits):
            (m, s, acc, acce), (mo, so, acco, acceo) = parts[a], parts[a ^ step]
            top = torch.maximum(m, mo)
            fs, fo = torch.exp2(m - top), torch.exp2(mo - top)
            merged.append((top, s * fs + so * fo, acc * fs[..., None] + acco * fo[..., None],
                           acce * fs[..., None] + acceo * fo[..., None]))
        parts, step = merged, 2 * step
    _, s, acc, acce = parts[0]
    out = out_scale[0].float()[None, :, None] * acc
    if relative is not None:
        out = out + out_scale[1].float()[None, :, None] * acce
    out = (out / s[..., None] + out_shift.float()[None, :, None])[:, :, :length]
    out = out.permute(0, 2, 1, 3).reshape(b, -1, length, g * gp)
    if not width_axis:
        out = out.transpose(1, 2)
    return out.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last), rescales


def _case(rng, b, h, w, g, gp, ks, wopos, sharp):
    """Seeded K6 operands (numpy); ``sharp`` scales the similarity so that
    rows' logits spread over tens of log2 units and references move."""
    qkv = rng.standard_normal((b, 2 * g * gp, h, w)).astype(np.float32)
    relative = None if wopos else (rng.standard_normal((2 * gp, 2 * ks - 1)) / gp ** 0.5
                                   ).astype(np.float32)
    sim_scale = (rng.random((3, g)) + 0.5).astype(np.float32) * sharp
    out_scale = (rng.random((2, g, gp)) + 0.5).astype(np.float32)
    if wopos:
        sim_scale[1:] = 0.0
        out_scale[1] = 0.0
    shift = (0.1 * rng.standard_normal((g, gp))).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    return (torch.from_numpy(qkv).contiguous(memory_format=torch.channels_last), t(relative),
            t(sim_scale), t(out_scale), t(shift))


def _rel_err(got, ref):
    return ((got - ref).abs().max() / ref.pow(2).mean().sqrt()).item()


# (b, h, w, gp, ks, wopos, width_axis): R x R tiles at 4, 2 and 1 rows a lane,
# key splits of 2 to 8 (L < 32 R), two query chunks (L > 32 R), partial last
# tiles, L < ks, wopos
EMULATED = [
    (1, 6, 128, 4, 128, False, True),     # R 4, one warp of 32 tiles
    (1, 64, 5, 4, 64, False, False),      # R 4, 2 key splits
    (2, 33, 3, 2, 40, False, False),      # R 4, L 33: a partial tile, L < ks
    (1, 4, 129, 2, 129, False, True),     # R 4, 33 tiles: two chunks
    (1, 3, 29, 8, 29, False, True),       # R 2, 15 tiles: 2 key splits, a partial tile
    (1, 5, 31, 16, 31, False, True),      # R 1: 31 lanes, one split
    (1, 9, 7, 4, 9, True, False),         # wopos, 3 tiles: 2 key splits
    (1, 2, 65, 32, 65, False, True),      # R 1, 65 tiles: three chunks
]


@pytest.mark.parametrize("b,h,w,gp,ks,wopos,width_axis", EMULATED)
@pytest.mark.parametrize("sharp", [1.0, 6.0])
def test_kernel_order_matches_reference(b, h, w, gp, ks, wopos, width_axis, sharp):
    """The kernel's order of arithmetic in f32 against the reference (f32):
    within 2e-5 of the output's rms, with the lazy rescale taken where the
    logits are spread."""
    args = _case(np.random.default_rng(gp * 1000 + w + h), b, h, w, 2, gp, ks, wopos, sharp)
    ref = k6.fused_axial_attention_reference(*args, ks, width_axis)
    got, rescales = emulate(*args, ks, width_axis)
    assert got.shape == ref.shape
    assert _rel_err(got, ref) <= 2e-5
    length = w if width_axis else h
    if sharp > 1 and length > 2 * k6.rows_per_lane(gp) * 4:
        assert rescales > 0


@pytest.mark.parametrize("fault,case", [
    ("rescale skipped", (1, 6, 128, 4, 128, False, True)),
    ("partial key tile dropped", (2, 33, 3, 2, 40, False, False)),
    ("key-split merge dropped", (1, 64, 5, 4, 64, False, False)),
])
def test_emulated_faults_fail(fault, case):
    """Each fault the card checks plant, planted into the emulation, reads
    far above the card's K6 limit (1e-3 of the output's rms) on inputs like
    the card checks'."""
    b, h, w, gp, ks, wopos, width_axis = case
    args = _case(np.random.default_rng(7), b, h, w, 2, gp, ks, wopos, 6.0)
    ref = k6.fused_axial_attention_reference(*args, ks, width_axis)
    got, _ = emulate(*args, ks, width_axis, fault=fault)
    assert not _rel_err(got, ref) <= 1e-2
