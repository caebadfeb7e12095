"""K1's tile plan (``ops/kernels/fused_up.py::plan``), on the CPU.

The plan lays out the two persistent grids of ``csrc/fused_up.cu``: the
ConvT GEMM's 128 x 128 tiles, and the conv's tiles of bh x bw fine pixels by
bn output channels, whose K steps each stage one 4-D halo box of 64
channels of up or skip at one column shift dx and read the three row shifts
dy from it by row offsets. These tests hold the plan's tiles, halo
coordinates and channel chunks to what the conv needs, and an emulation of
the kernel's schedule in plain torch (boxes with their zero fill, tap row
offsets, chunks and their weight rows, the staged epilogues) to the plain
version.
"""

import numpy as np
import pytest
import torch

from unet_zoo_tpu_torch.ops.kernels import fused_up as k1

CL = torch.channels_last


def test_served_stages_plan():
    # unet's four decoder stages at B=8, 256px: (Cin, Cu, Hc)
    for cin, cu, hc in [(1024, 512, 16), (512, 256, 32), (256, 128, 64), (128, 64, 128)]:
        p = k1.plan(8, hc, hc, cin, cu, cu, cu)
        assert (p.bh, p.bm) == ((16, 256) if cu == 64 else (8, 128))
        assert p.bn == (64 if cu == 64 else 128)
        assert p.chunks_u == p.chunks_s == cu // 64
        assert p.grid_conv == min(p.conv_tiles, k1.SMS)
        # two ConvT blocks an SM where its K is short (Cin <= 256)
        assert p.convt_ctas == (2 if cin <= 256 else 1)
        assert p.grid_convt == min(p.convt_tiles, k1.SMS * p.convt_ctas)
        for tiles, blocks in ((p.conv_tiles, k1.SMS), (p.convt_tiles, k1.SMS * p.convt_ctas)):
            assert tiles / (-(-tiles // blocks) * blocks) >= 0.96  # rounds all but full


def _conv_counts(p, b, hf, wf):
    counts = np.zeros((b, hf, wf), np.int64)
    for t in range(p.conv_tiles):
        bb, h0, w0, n0 = k1.conv_tile(p, t)
        if n0 == 0:
            counts[bb, h0:h0 + p.bh, w0:w0 + k1.BW] += 1
    return counts


@pytest.mark.parametrize("hc_lo", [1, 17, 33, 49])
def test_conv_tiles_cover_every_pixel_once(hc_lo):
    # fine sizes 2..130 in both directions: every output pixel in exactly one
    # tile (for each column tile), whatever the tile shape the plan picks
    for hc in range(hc_lo, hc_lo + 16 + (hc_lo == 49)):
        for wc in range(1, 66):
            p = k1.plan(2, hc, wc, 32, 32, 32, 8 if hc % 2 else 128)
            assert p.bh * k1.BW == p.bm
            assert (1, p.bn, 1) in k1.SOURCE_TILES and (0, 128, p.convt_ctas) in k1.SOURCE_TILES
            counts = _conv_counts(p, 2, 2 * hc, 2 * wc)
            assert counts.min() == 1 and counts.max() == 1, (hc, wc)


def test_conv_tiles_cover_every_column_once():
    for co in range(8, 1025, 8):
        p = k1.plan(1, 3, 5, 32, 32, 32, co)
        cols = np.zeros(co, np.int64)
        for t in range(p.conv_tiles):
            bb, h0, w0, n0 = k1.conv_tile(p, t)
            if (bb, h0, w0) == (0, 0, 0):
                cols[n0:n0 + p.bn] += 1
        assert cols.min() == 1 and cols.max() == 1, co
        assert p.nt * p.bn >= co > (p.nt - 1) * p.bn


@pytest.mark.parametrize("b,hc,wc,cu", [(1, 1, 1, 32), (3, 5, 7, 32), (2, 9, 13, 96),
                                        (8, 16, 16, 512), (1, 11, 130, 64)])
def test_convt_tiles_cover_every_element_once(b, hc, wc, cu):
    p = k1.plan(b, hc, wc, 64, cu, 32, 8)
    m, n = b * hc * wc, 4 * cu
    counts = np.zeros((m, n), np.int64)
    for t in range(p.convt_tiles):
        m0, n0 = k1.convt_tile(p, t)
        counts[m0:m0 + k1.BM, n0:n0 + k1.CONVT_BN] += 1
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("hc,wc", [(1, 1), (4, 4), (5, 7), (16, 3)])
def test_halo_boxes_address_the_taps_input_pixels(hc, wc):
    # tap (dy, dx) of output row r = oh * bw + ow reads box row r + dy * bw of
    # the dx box, which must be input pixel (h0 + oh + dy - 1, w0 + ow + dx -
    # 1): negative coordinates and those past the image are the zero padding
    b, hf, wf = 2, 2 * hc, 2 * wc
    p = k1.plan(b, hc, wc, 32, 32, 32, 8)
    for t in range(p.conv_tiles):
        bb, h0, w0, _ = k1.conv_tile(p, t)
        for dx in range(3):
            c0, bw0, bh0, bb0 = k1.halo_origin(bb, h0, w0, 0, dx)
            assert (c0, bb0) == (0, bb)
            for r in range(p.bm):
                oh, ow = divmod(r, k1.BW)
                for dy in range(3):
                    i, j = divmod(r + dy * k1.BW, k1.BW)
                    assert i < p.bh + 2
                    assert (bh0 + i, bw0 + j) == (h0 + oh + dy - 1, w0 + ow + dx - 1)
        assert k1.halo_origin(bb, 0, 0, 0, 0)[1:3] == (-1, -1)


@pytest.mark.parametrize("cu", [32, 64, 96, 128, 160, 512, 1024])
@pytest.mark.parametrize("cs", [32, 64, 96, 256])
def test_chunks_never_straddle_up_and_skip(cu, cs):
    # each step's box holds channels of one source; its real channels are
    # the concat's channels k0 .. (the weight rows it reads), every channel
    # of up and skip lies in exactly one chunk, and each chunk takes all
    # three column shifts
    p = k1.plan(1, 2, 2, 32, cu, cs, 8)
    seen = np.zeros(cu + cs, np.int64)
    steps = k1.conv_steps(p, cu)
    assert len(steps) == 3 * (p.chunks_u + p.chunks_s)
    for src, c0, k0, dx in steps:
        width = cu if src == 0 else cs
        assert 0 <= c0 < width and c0 % k1.KC == 0
        real = min(k1.KC, width - c0)
        assert k0 == src * cu + c0
        assert k0 + real <= (cu if src == 0 else cu + cs)  # never into the other source
        if dx == 0:
            seen[k0:k0 + real] += 1
    assert seen.min() == 1 and seen.max() == 1
    assert [s[0] for s in steps] == sorted(s[0] for s in steps)  # up first, then skip


def _emulate(y, skip, wt, bt, wc, scale, bias):
    """The kernel's schedule in plain torch: the ConvT's tiles and their
    depth-to-space epilogue, then the conv's tiles, each K step one zero-
    filled 64-channel halo box at one column shift read at three row
    offsets against the weight rows the kernel's tensor map returns (zeros
    past the matrix), sums in f32, bf16 out."""
    b, cin, hc, wcs = y.shape
    cs, hf, wf = skip.shape[1], 2 * hc, 2 * wcs
    cu, co = wt.shape[1] // 4, wc.shape[1]
    c2 = cu + cs
    p = k1.plan(b, hc, wcs, cin, cu, cs, co)
    wt_k, wc_k = (t.float() for t in k1.pack_kernel_weights(wt, wc))

    # ConvT: [M, Cin] x [Cin, 4 Cu] in 128 x 128 tiles, K in chunks of 64
    y2 = y.permute(0, 2, 3, 1).reshape(-1, cin).float()
    m = y2.shape[0]
    up = torch.zeros(b, hf, wf, cu, dtype=torch.bfloat16)
    for t in range(p.convt_tiles):
        m0, n0 = k1.convt_tile(p, t)
        acc = torch.zeros(k1.BM, k1.CONVT_BN)
        for k0 in range(0, cin, k1.KC):
            a = torch.zeros(k1.BM, k1.KC)
            blk = y2[m0:m0 + k1.BM, k0:k0 + k1.KC]
            a[:blk.shape[0], :blk.shape[1]] = blk
            wk = torch.zeros(k1.CONVT_BN, k1.KC)
            wblk = wt_k[n0:n0 + k1.CONVT_BN, k0:k0 + k1.KC]
            wk[:wblk.shape[0], :wblk.shape[1]] = wblk
            acc += a @ wk.t()
        for r in range(min(k1.BM, m - m0)):
            mm = m0 + r
            bb, rem = divmod(mm, hc * wcs)
            hh, ww = divmod(rem, wcs)
            for c in range(0, k1.CONVT_BN, 8):
                n = n0 + c
                phase, cc = divmod(n, cu)
                up[bb, 2 * hh + phase // 2, 2 * ww + phase % 2, cc:cc + 8] = (
                    acc[r, c:c + 8] + bt[cc:cc + 8].float()).to(torch.bfloat16)

    sources = (up.float(), skip.permute(0, 2, 3, 1).float())
    out = torch.zeros(b, hf, wf, co, dtype=torch.bfloat16)
    for t in range(p.conv_tiles):
        bb, h0, w0, n0 = k1.conv_tile(p, t)
        acc = torch.zeros(p.bm, p.bn)
        for src, c0, k0, dx in k1.conv_steps(p, cu):
            c_, bw0, bh0, b_ = k1.halo_origin(bb, h0, w0, c0, dx)
            box = torch.zeros(p.bh + 2, k1.BW, k1.KC)
            x = sources[src][b_]
            for i in range(p.bh + 2):
                for j in range(k1.BW):
                    hh, ww = bh0 + i, bw0 + j
                    if 0 <= hh < hf and 0 <= ww < wf:
                        chans = x[hh, ww, c_:c_ + k1.KC]
                        box[i, j, :chans.shape[0]] = chans
            rows = box.reshape(-1, k1.KC)
            for dy in range(3):
                a = rows[dy * k1.BW:dy * k1.BW + p.bm]
                kk = (3 * dy + dx) * c2 + k0
                wk = torch.zeros(p.bn, k1.KC)
                wblk = wc_k[n0:n0 + p.bn, kk:kk + k1.KC]
                wk[:wblk.shape[0], :wblk.shape[1]] = wblk
                acc += a @ wk.t()
        for r in range(p.bm):
            oh, ow = divmod(r, k1.BW)
            hh, ww = h0 + oh, w0 + ow
            if hh < hf and ww < wf:
                n1 = min(n0 + p.bn, co)
                v = acc[r, :n1 - n0] * scale[n0:n1].float() + bias[n0:n1].float()
                out[bb, hh, ww, n0:n1] = torch.relu(v).to(torch.bfloat16)
    return out.permute(0, 3, 1, 2).contiguous(memory_format=CL), up


@pytest.mark.parametrize("b,hc,wc,cin,cu,cs,co", [
    (1, 4, 6, 64, 32, 32, 16),      # Cu = Cs = 32: both chunks half past their source
    (2, 5, 7, 96, 64, 32, 40),      # ragged tiles, Cin with a half chunk, Co 40
    (1, 8, 12, 96, 96, 64, 72),     # Cu 96: up's second chunk runs into skip's weights
    (1, 16, 16, 128, 64, 64, 136),  # 32 px, two column tiles of 128
])
def test_schedule_emulation_matches_reference(b, hc, wc, cin, cu, cs, co):
    torch.set_num_threads(1)
    rng = np.random.default_rng(hc * 100 + co)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    bf = torch.bfloat16
    y = t(b, cin, hc, wc).to(bf).contiguous(memory_format=CL)
    skip = t(b, cs, 2 * hc, 2 * wc).to(bf).contiguous(memory_format=CL)
    wt = (t(cin, 4 * cu) / cin ** 0.5).to(bf)
    wc_ = (t(9 * (cu + cs), co) / (9 * (cu + cs)) ** 0.5).to(bf)
    bt, scale, bias = t(cu) * 0.1, 1.0 + 0.2 * t(co), 0.1 * t(co)
    got, up = _emulate(y, skip, wt, bt, wc_, scale, bias)
    ref = k1.fused_up_concat_conv_reference(y, skip, wt, bt, wc_, scale, bias)
    # up: the kernel's bf16 intermediate, against the reference's ConvT
    up_ref = torch.nn.functional.conv_transpose2d(
        y.float(), wt.float().reshape(cin, 2, 2, cu).permute(0, 3, 1, 2), bt, stride=2)
    ex = (up.permute(0, 3, 1, 2).float() - up_ref).abs() - 2.0 ** -8 * up_ref.abs()
    assert ex.max().item() <= 1e-6
    # the output, both rounded to bf16 once: at most one ulp apart
    ex = (got.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
    assert (ex.max() / ref.float().pow(2).mean().sqrt()).item() <= 1e-3


def test_every_ring_fits_its_share_of_shared_memory():
    for mode, bn, ctas in k1.SOURCE_TILES:
        stages, stage, a, smem = k1.ring(mode, bn, ctas)
        assert stages >= 2 and a % 1024 == 0 and stage % 1024 == 0
        assert smem <= (k1.SMEM_LIMIT if ctas == 1 else k1.SMEM_HALF)
        assert ctas * (smem + 1024) <= 233472  # an SM's 228 KB, 1 KB a block reserved


def test_kernel_weights_are_the_transposes():
    rng = np.random.default_rng(0)
    wt = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(torch.bfloat16)
    wc = torch.from_numpy(rng.standard_normal((576, 40)).astype(np.float32)).to(torch.bfloat16)
    wt_k, wc_k = k1.pack_kernel_weights(wt, wc)
    assert wt_k.is_contiguous() and wc_k.is_contiguous()
    assert torch.equal(wt_k, wt.t()) and torch.equal(wc_k, wc.t())
