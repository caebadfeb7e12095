"""K4's host-side planning and weight packing (CPU).

The CUDA kernel (``csrc/mkblock.cu``) picks its MLP form by C and reads w1
and w2 K-contiguous; the wrapper mirrors the form's shared-memory layout and
plans the grids in plain Python (``ops/kernels/mkblock.py``), so these run
here. ``tests/test_torch_kernels_cuda.py`` holds the mirror against the
built source on the card.
"""

import pytest
import torch

from unet_zoo_tpu_torch.models.mmunet import MKBlock
from unet_zoo_tpu_torch.nn import init_weights
from unet_zoo_tpu_torch.ops.kernels import mkblock as k4

torch.set_num_threads(1)

SMS = 132
# mmunet (base 96) at 256px, B = 8: (C, H = W)
MMUNET_SHAPES = [(96, 256), (192, 128), (192, 64), (384, 32), (768, 16), (768, 8), (384, 16),
                 (192, 32), (96, 128)]


def _block(c, seed=0):
    blk = MKBlock(c)
    g = torch.Generator().manual_seed(seed)
    init_weights(blk, g)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
    return blk.eval()


@pytest.mark.parametrize("c,resident,smem,hc", [
    (32, True, 33840, 128), (64, True, 99392, 128), (96, True, 197712, 128),
    (128, False, 132160, 64), (160, False, 164928, 64), (192, False, 197696, 64)])
def test_fused_layout(c, resident, smem, hc):
    """The fused form's shared memory, as Fused<C> lays it out: w1 and w2
    stay resident up to C = 96 (144 KB of weights beside two 24 KB h0 tiles
    at 96) and stream through two stages above; every layout fits a block."""
    assert k4.fused_layout(c) == (resident, smem)
    assert k4.hidden_chunk(c) == hc and (4 * c) % hc == 0
    assert smem <= k4.SMEM_LIMIT


@pytest.mark.parametrize("c,h", MMUNET_SHAPES)
def test_plan_at_mmunet_shapes(c, h):
    m = 8 * h * h
    p = k4.plan(m, c, SMS)
    if c <= k4.FUSED_MAX_C:
        tiles = -(-m // k4.BM)
        assert p.form == "fused" and p.splits == 1
        assert (p.resident, p.smem) == k4.fused_layout(c)
        assert p.grid == min(tiles, SMS)
    else:
        assert p.form == "gemm" and not p.resident
        out_tiles = -(-m // k4.GEMM_BM) * (c // k4.GEMM_BN)
        assert p.grid == out_tiles * p.splits <= max(SMS, out_tiles)
        assert 4 * c // k4.GEMM_BK // p.splits >= k4.MIN_SPLIT_K_TILES


@pytest.mark.parametrize("m,c,want", [
    (512, 768, ("gemm", 120, 5)),       # 4 x 6 tiles: five K splits of 9-10 boxes
    (2048, 384, ("gemm", 96, 2)),       # 16 x 3 tiles: two splits
    (2048, 768, ("gemm", 96, 1)),       # 16 x 6 tiles: no split
    (8192, 384, ("gemm", 192, 1)),      # more tiles than SMs
    (2048, 224, ("gemm", 32, 1)),       # 14 K boxes: too few to split
    (35, 96, ("fused", 1, 1)),          # below one row tile
    (35, 192, ("fused", 1, 1)),         # the same, weights streamed
    (132 * 128 + 1, 192, ("fused", 132, 1)),   # one more than a whole wave
    (3 * 128, 160, ("fused", 3, 1)),    # a 64-byte K box
    (524288, 96, ("fused", 132, 1)),
])
def test_plan_edges(m, c, want):
    p = k4.plan(m, c, SMS)
    assert (p.form, p.grid, p.splits) == want


def test_pack_mkblock_weights_matches_fold():
    """The packed w1 and w2 are the folded ones transposed, exactly: pwconv1's
    weight with norm4's scale folded in, and pwconv2's weight, in bf16."""
    c = 64
    blk = _block(c)
    folded = k4.fold_mkblock_params(blk)
    packed = k4.pack_mkblock_weights(folded.w1, folded.w2)
    assert packed.w1t.shape == (4 * c, c) and packed.w2t.shape == (c, 4 * c)
    assert packed.w1t.is_contiguous() and packed.w2t.is_contiguous()
    assert torch.equal(packed.w1t, folded.w1.t())
    assert torch.equal(packed.w2t, folded.w2.t())
    s4 = blk.norm4.weight / torch.sqrt(blk.norm4.running_var + blk.norm4.eps)
    assert torch.equal(packed.w1t, (blk.pwconv1.weight.float() * s4).to(torch.bfloat16))
    assert torch.equal(packed.w2t, blk.pwconv2.weight.to(torch.bfloat16))


def test_freeze_packs_once():
    blk = _block(32)
    blk.freeze_kernel_weights()
    want = k4.pack_mkblock_weights(blk._frozen.w1, blk._frozen.w2)
    assert torch.equal(blk._packed.w1t, want.w1t) and torch.equal(blk._packed.w2t, want.w2t)


@pytest.mark.parametrize("which,shape,dtype,err", [
    ("w1t", (128, 64), torch.bfloat16, ValueError),    # [C, 4C]: not transposed
    ("w2t", (32, 128), torch.float32, TypeError),      # not bf16
])
def test_packed_argument_checks(which, shape, dtype, err):
    c = 32
    x = torch.zeros(1, c, 5, 7, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    folded = k4.fold_mkblock_params(_block(c))
    good = k4.pack_mkblock_weights(folded.w1, folded.w2)
    assert k4._check_kernel_args(x, *folded, good) == (1, c, 5, 7)
    bad = good._replace(**{which: torch.zeros(shape, dtype=dtype)})
    with pytest.raises(err, match=which):
        k4._check_kernel_args(x, *folded, bad)
