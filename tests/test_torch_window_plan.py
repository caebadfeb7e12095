"""K2's host-side plan and the mma instance's arithmetic (CPU).

The served instance of the CUDA kernel (``csrc/window_attention.cu``,
``window_attention_mma_kernel``) gives a block several windows of one head
and one mask index, forms S = q k^T on the tensor cores from bf16 products
summed in f32, and runs P.V on them too with the normalised f32 P split
into bf16 P_hi + P_lo. The wrapper plans the launch in plain Python
(``ops/kernels/window_attention.py::plan``), so the plan is checked here,
and :func:`emulate` repeats the instance's arithmetic in PyTorch to hold it
against ``swin_window_attention_reference`` at K2's reading.
``tests/test_torch_kernels_cuda.py`` holds the plan against the numbers the
built source exports, and the kernel against the plain version, on the card.
"""

import numpy as np
import pytest
import torch

from unet_zoo_tpu_torch.ops.kernels import window_attention as k2

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
SMEM_LIMIT = 232448        # an H100 block's dynamic shared memory
K2_SHARE = 1e-3            # chip_smoke.py's K2_SHARE
SWIN_CONFIGS = [(224, 7), (256, 8)]


def launch_shapes(image, window, batch):
    """K2's launch shapes in one registry-default swin_unet_v2 forward at
    ``batch`` images: (B_, nh, N, hd, nW), nW 1 for an unshifted block."""
    return [row[:5] for row in k2.launch_shapes(image, window, batch)]


SERVED = sorted({s for image, window in SWIN_CONFIGS for s in launch_shapes(image, window, 8)})
# B_ 6 with nW 3 and hd 16; N not a multiple of 16 (windows 6, 5 and 3); N 16
ODD = [(6, 5, 49, 16, 3), (10, 4, 36, 32, 2), (4, 3, 25, 16, 1), (18, 2, 9, 32, 9),
       (3, 7, 64, 16, 1), (12, 2, 16, 16, 4)]
PLAN_CASES = sorted({s for image, window in SWIN_CONFIGS for b in range(1, 9)
                     for s in launch_shapes(image, window, b)}) + ODD


def blocks_of(p, b_, nh, nw, fault=False):
    """The (window, head) pairs each block of plan ``p`` takes, and its mask
    index, following the kernel's block decomposition; ``fault`` follows the
    source's planted fault (consecutive windows, one mask index)."""
    for bid in range(p.grid):
        c, m, h = bid % p.chunks, (bid // p.chunks) % nw, bid // (p.chunks * nw)
        first = c * p.windows_per_block
        ts = range(first, min(first + p.windows_per_block, p.per_group))
        windows = [m * p.per_group + t if fault else m + nw * t for t in ts]
        yield m, [(b, h) for b in windows]


@pytest.mark.parametrize("b_,nh,n,hd,nw", PLAN_CASES)
def test_plan_covers_every_pair_once_with_one_mask_a_block(b_, nh, n, hd, nw):
    p = k2.plan(b_, nh, n, hd, nw)
    assert p == k2.layout(b_, nh, hd, nw, p.windows_per_block)
    assert 1 <= p.windows_per_block <= k2.MAX_WINDOWS_PER_BLOCK
    assert p.per_group * nw == b_ and p.grid == nh * nw * p.chunks
    count = np.zeros((b_, nh), np.int32)
    for m, pairs in blocks_of(p, b_, nh, nw):
        assert pairs, "a block with no window"
        assert len({h for _, h in pairs}) == 1          # one head's tables a block
        if nw > 1:
            assert all(b % nw == m for b, _ in pairs)   # one mask a block
        for b, h in pairs:
            count[b, h] += 1
    assert (count == 1).all()
    # the grid fills the SMs where there are that many (window, head) pairs
    assert p.grid >= min(k2.SMS, b_ * nh)
    # three blocks an SM fit the shared memory; one block fits the limit
    assert p.threads == k2.MMA_THREADS and p.smem == k2.mma_smem_bytes(hd)
    assert 3 * p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("b_,nh,n,hd,nw", [s for s in SERVED if s[4] > 1] + [ODD[0], ODD[1]])
def test_planted_fault_covers_every_pair_but_reads_other_masks(b_, nh, n, hd, nw):
    """The source's planted fault (a block's windows consecutive, one mask
    index) still writes every pair once, so only the masks tell it apart."""
    p = k2.plan(b_, nh, n, hd, nw)
    count = np.zeros((b_, nh), np.int32)
    wrong = 0
    for m, pairs in blocks_of(p, b_, nh, nw, fault=True):
        for b, h in pairs:
            count[b, h] += 1
            wrong += b % nw != m
    assert (count == 1).all() and wrong > 0


@pytest.mark.parametrize("image,window,embed,depths,heads", [
    (224, 7, 96, (2, 2, 2, 2), (3, 6, 12, 24)), (256, 8, 96, (2, 2, 2, 2), (3, 6, 12, 24)),
    (64, 4, 16, (2, 2, 2, 2), (1, 2, 2, 4)), (96, 6, 8, (1, 3, 2), (1, 2, 4))])
def test_launch_shapes_are_the_models_blocks(image, window, embed, depths, heads):
    """k2.launch_shapes (the rows chip_smoke.py and probes/window_grids.py
    time) against the attention of every SwinBlockV2 the model builds, with
    its window, heads, head width and mask."""
    from unet_zoo_tpu_torch.models.swin_unet_v2 import SwinBlockV2, SwinUNetV2

    batch = 3
    model = SwinUNetV2(img_size=image, num_classes=1, embed_dim=embed, depths=depths,
                       num_heads=heads, window_size=window)
    built = {}
    for m in model.modules():
        if isinstance(m, SwinBlockV2):
            (h, w), nh = m.input_resolution, m.attn.num_heads
            nw = (h // m.window) * (w // m.window)
            hd = m.norm1.normalized_shape[0] // nh
            key = (batch * nw, nh, m.window ** 2, hd, nw if m.attn_mask is not None else 1)
            assert m.attn_mask is None or m.attn_mask.shape[0] == nw
            built[key] = built.get(key, 0) + 1
    rows = k2.launch_shapes(image, window, batch, embed, depths, heads)
    assert {row[:5]: row[5] for row in rows} == built and len(rows) == len(built)


def test_plan_of_the_served_shapes():
    """The plan's picks at 224px/window 7 (B=8): stages 0-1 share a head's
    tables over several windows; stages 2-3 have one window a block, and
    every grid fills the 132 SMs."""
    picks = {s: k2.plan(*s).windows_per_block for s in launch_shapes(224, 7, 8)}
    assert picks[(512, 3, 49, 32, 64)] == 4 and picks[(512, 3, 49, 32, 1)] == 4
    assert picks[(128, 6, 49, 32, 16)] == 2 and picks[(128, 6, 49, 32, 1)] == 2
    assert picks[(32, 12, 49, 32, 4)] == 1 and picks[(8, 24, 49, 32, 1)] == 1
    assert all(k2.plan(*s).grid >= k2.SMS for s in launch_shapes(224, 7, 8))


@pytest.mark.parametrize("b_,nh,n,hd,nw", [(8, 2, 65, 32, 1), (8, 2, 49, 24, 1),
                                           (8, 2, 49, 64, 1), (6, 2, 49, 32, 4)])
def test_plan_refuses_what_the_mma_instance_does_not_take(b_, nh, n, hd, nw):
    with pytest.raises(ValueError, match="no mma plan"):
        k2.plan(b_, nh, n, hd, nw)


def instance_of(q, k=None, v=None):
    return k2.instance(q, q if k is None else k, q if v is None else v)


def test_instance_by_shape_type_and_alignment():
    """bf16, N <= 64, hd 16 or 32 and 16-byte rows take the mma instance;
    float32, N 100, hd 24 or a row off 16 bytes take the general one."""
    proj = torch.zeros(4, 49, 3, 3, 32, dtype=torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in proj.unbind(2))
    assert instance_of(q, k, v) == "mma"
    assert instance_of(q.float(), k.float(), v.float()) == "general"
    assert instance_of(torch.zeros(2, 2, 100, 32, dtype=torch.bfloat16)) == "general"
    assert instance_of(torch.zeros(2, 2, 49, 24, dtype=torch.bfloat16)) == "general"
    off = torch.zeros(2 * 2 * 49 * 32 + 1, dtype=torch.bfloat16)[1:].view(2, 2, 49, 32)
    assert instance_of(off) == "general"
    odd_stride = torch.zeros(2, 49, 2, 36, dtype=torch.bfloat16)[..., :32].transpose(1, 2)
    assert instance_of(odd_stride) == "general"


def k2_case(rng, b_, nh, n, hd, nw):
    """chip_smoke.py's ``k2_case`` recipe in numpy: q, k and v from one bf16
    [B_, N, 3, nh, hd] projection with an all-zero q row and k row; tau from
    U(0.005, 0.1), so some entries lie below the 0.01 clip; a bias of a few
    units; a random 0 / -100 mask of nW windows, None for nW 1."""
    qkv = torch.from_numpy(rng.standard_normal((b_, n, 3, nh, hd), dtype=np.float32))
    qkv = qkv.to(torch.bfloat16)
    qkv[0, 1, 0, 0] = 0.0
    qkv[0, 2, 1, 0] = 0.0
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    tau = torch.from_numpy(rng.uniform(0.005, 0.1, (nh, n, n)).astype(np.float32))
    bias = torch.from_numpy(3.0 * rng.standard_normal((nh, n, n), dtype=np.float32))
    mask = None
    if nw > 1:
        mask = torch.from_numpy(np.where(rng.random((nw, n, n)) < 0.3, -100.0, 0.0)
                                .astype(np.float32))
    return q, k, v, tau, bias, mask


def emulate(q, k, v, tau, bias, mask, split=True):
    """The mma instance's arithmetic: S from the bf16 operands' exact
    products summed in f32, norms in f32, the cosine, tau and bias + mask
    with log2 e folded in, a softmax by exp2, P normalised in f32 and split
    into bf16 hi + lo (or, with ``split=False``, rounded once to bf16), both
    parts against the bf16 V summed in f32, the output rounded to bf16."""
    b_, nh, n, _ = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = q32 @ k32.transpose(-1, -2)
    qn = torch.linalg.vector_norm(q32, dim=-1)[..., :, None]
    kn = torch.linalg.vector_norm(k32, dim=-1)[..., None, :]
    x = s / torch.clamp_min(qn * kn, 1e-6)
    itau = LOG2E / tau.clamp_min(0.01)
    bm = bias.expand(b_, nh, n, n)
    if mask is not None:
        nw = mask.shape[0]
        bm = (bm.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]).reshape(b_, nh, n, n)
    a = x * itau + bm * LOG2E
    e = torch.exp2(a - a.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    out = hi @ v32
    if split:
        out = out + (p - hi).to(torch.bfloat16).float() @ v32
    return out.to(torch.bfloat16)


def reading(got, ref):
    """chip_smoke.py's ``k6_reading``: the error beyond the output's bf16
    rounding, max (|got - ref| - 2^-8 |ref|), over the output's rms."""
    excess = (got.float() - ref).abs() - 2.0 ** -8 * ref.abs()
    return (excess.max() / ref.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("b_,nh,n,hd,nw", SERVED + [ODD[0], ODD[1]])
def test_emulated_split_p_matches_reference(b_, nh, n, hd, nw):
    rng = np.random.default_rng(b_ * 1000 + nh * 100 + n + hd + nw)
    q, k, v, tau, bias, mask = k2_case(rng, b_, nh, n, hd, nw)
    ref = k2.swin_window_attention_reference(q.float(), k.float(), v.float(), tau, bias, mask)
    got = emulate(q, k, v, tau, bias, mask)
    assert torch.isfinite(got.float()).all()
    assert reading(got, ref) <= K2_SHARE


@pytest.mark.parametrize("b_,nh,n,hd,nw", [(32, 12, 49, 32, 4), (8, 24, 64, 32, 1)])
def test_p_rounded_once_reads_larger_than_the_split(b_, nh, n, hd, nw):
    """P rounded once to bf16 before P.V (what the module path does) lands
    further from the f32 reference than the hi + lo split, by reading and by
    the largest error."""
    rng = np.random.default_rng(7 + n)
    q, k, v, tau, bias, mask = k2_case(rng, b_, nh, n, hd, nw)
    ref = k2.swin_window_attention_reference(q.float(), k.float(), v.float(), tau, bias, mask)
    split, once = emulate(q, k, v, tau, bias, mask), emulate(q, k, v, tau, bias, mask, False)
    assert reading(once, ref) > reading(split, ref)
    assert (once.float() - ref).abs().max() > (split.float() - ref).abs().max()
