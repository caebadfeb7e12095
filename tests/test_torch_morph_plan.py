"""K5's host-side plan (CPU).

The CUDA kernel (``csrc/morph.cu``) writes each pixel's softmax statistics,
then streams rows through strips of ``tw`` output columns and bands of
``bh`` output rows, ``cb`` channels a block; the wrapper plans all of it in
plain Python (``ops/kernels/morph.py::plan``), so these run here.
``tests/test_torch_kernels_cuda.py`` holds the plan against the numbers the
built source exports, on the card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_zoo_tpu_torch.ops.kernels import morph as k5

torch.set_num_threads(1)

# mmunet (base 96) at 256px: (C, H = W, repeat) of its morphology gates
SERVED = [(768, 16, 2), (384, 32, 2), (192, 64, 2), (192, 128, 2), (96, 256, 1)]
ODD = [(1, 16, 9, 9, 1), (2, 16, 9, 9, 2), (1, 24, 13, 29, 2), (3, 24, 13, 29, 1),
       (1, 8, 37, 29, 2), (2, 16, 5, 70, 1), (1, 24, 70, 5, 2), (2, 96, 40, 24, 1),
       (1, 192, 61, 277, 2), (1, 40, 33, 100, 1), (8, 64, 64, 64, 1), (8, 128, 64, 64, 1),
       # no block of MIN_CB channels or more fits: the plan takes narrower ones
       (8, 176, 64, 64, 2), (8, 208, 64, 64, 2), (8, 232, 64, 64, 1)]
CASES = [(b, c, h, h, r) for c, h, r in SERVED for b in range(1, 9)] + ODD


def _check(b, c, h, w, repeat):
    p = k5.plan(b, c, h, w, repeat)
    r = 3 * repeat
    nv = p.cb // 8
    # channels: whole 16-byte vectors, groups that tile C
    assert p.cb % 8 == 0 and c % p.cb == 0 and p.grid[1] == c // p.cb and p.grid[2] == b
    # halos: the staged columns and the rows a band walks hold at least
    # R = 3 * repeat beside every strip and band
    assert p.threads % nv == 0 and p.threads // nv - p.tw >= 2 * r and p.rows - p.bh >= 2 * r
    # one 16-byte cell a thread: the strip and its halo, cb / 8 vectors
    assert p.threads == (p.tw + 2 * r) * nv <= k5.max_threads(repeat)
    assert p.smem == k5.pool_smem(p.threads, repeat) <= k5.SMEM_LIMIT
    # statistics: warps whose lanes split a pixel's vectors cover every pixel
    lanes = p.lanes
    assert lanes & (lanes - 1) == 0 and 32 % lanes == 0 and (c // 8) % lanes == 0
    assert p.stats_blocks * (k5.STATS_THREADS // 32) * (32 // lanes) >= b * h * w
    return p


def _coverage(b, c, h, w, p):
    """How many blocks write each output (image, channel vector, row, column)."""
    strips = -(-w // p.tw)
    count = np.zeros((b, c // 8, h, w), np.int32)
    for bx in range(p.grid[0]):
        x0, y0 = (bx % strips) * p.tw, (bx // strips) * p.bh
        for by in range(p.grid[1]):
            v0 = by * p.cb // 8
            count[:, v0:v0 + p.cb // 8, y0:y0 + p.bh, x0:x0 + p.tw] += 1
    return count


@pytest.mark.parametrize("b,c,h,w,repeat", CASES)
def test_plan_fits_and_covers_every_output_once(b, c, h, w, repeat):
    p = _check(b, c, h, w, repeat)
    assert p.grid[0] == -(-w // p.tw) * -(-h // p.bh)
    assert (_coverage(b, c, h, w, p) == 1).all()


@pytest.mark.parametrize("c,h,repeat", SERVED)
def test_served_plans_fill_the_card(c, h, repeat):
    """At B = 8 every gate's pool grid has at least TARGET_BLOCKS blocks that
    each read at least MIN_CB channels (48 bytes) of a pixel."""
    p = k5.plan(8, c, h, h, repeat)
    assert p.grid[0] * p.grid[1] * p.grid[2] >= k5.TARGET_BLOCKS
    assert p.cb >= k5.MIN_CB


def test_widest_gate_pool_reads_x_about_once():
    """96 channels at 256px (the two edge-module gates, 74% of K5's bytes):
    the pool grid's staged rows, halos included, read at most 1.3 times the
    input."""
    b, c, h, repeat = 8, 96, 256, 1
    p = k5.plan(b, c, h, h, repeat)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    assert blocks * (p.bh + 6) * p.threads <= 1.3 * b * h * h * c // 8


@pytest.mark.parametrize("repeat", [1, 2])
def test_every_aligned_channel_count_has_a_plan(repeat):
    """mmunet's gate sends every C that is a multiple of 8 to the kernel, so
    every such C has a plan, at small and large images alike."""
    for c in range(8, 2049, 8):
        for h, w in ((9, 9), (64, 64), (256, 256)):
            _check(1, c, h, w, repeat)


@pytest.mark.parametrize("c,lanes", [(8, 1), (16, 2), (24, 1), (96, 4), (192, 8), (384, 16),
                                     (768, 32), (1536, 32)])
def test_stats_lanes(c, lanes):
    assert k5.stats_lanes(c) == lanes


@pytest.mark.parametrize("repeat", [1, 2])
def test_second_round_repad_leaves_the_pools_unchanged(repeat):
    """Two 7x7 max pools with -inf padding are one 13x13 max pool with -inf
    padding: the first round's values outside the image are maxima over
    windows that a window inside the image also covers. So the re-pad
    before the second round changes nothing, and a kernel that skipped it
    would compute the same d and e; the card tests plant a wrong re-pad
    instead. Checked here on the plain version, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(repeat).standard_normal((2, 16, 11, 13))
                         ).float() * 2
    sm = torch.softmax(x, dim=1)
    once = F.pad(sm, (3 * repeat,) * 4, value=-float("inf"))
    for _ in range(repeat):
        once = F.max_pool2d(once, 7, 1)
    d, _ = k5.fused_softmax_morph_reference(x, 7, repeat)
    assert torch.equal(once, d)
