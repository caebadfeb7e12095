"""K8's host-side plan and its step schedule (CPU).

The CUDA kernel (``csrc/deform.cu``) runs one persistent block an SM; each
warp owns a 2-D patch of 16 output pixels of a block tile and walks its
taps on its own (samples formed a tap ahead, a gather and a product per
channel chunk). The wrapper plans patch, block tile, chunks, tap groups
and shared memory in plain Python (``ops/kernels/deform.py::plan``), so
these run here, and an emulation of the kernel's schedule (its prefetch
across taps and tiles, tap groups and chunk loop, the blend rounded as the
kernel rounds it) is held against the plain version. ``tests/test_torch_kernels_cuda.py`` holds the plan against the
numbers the built source exports, on the card.
"""

import numpy as np
import pytest
import torch

from unet_zoo_tpu_torch.ops.deform import out_size
from unet_zoo_tpu_torch.ops.kernels import deform as k8

torch.set_num_threads(1)

CHANNELS = [1, 3, 8, 20, 40, 64, 128, 200, 256, 496, 1000]
OUTS = [1, 5, 16, 24, 32, 33, 64, 100, 128]
TAPS = [1, 9, 25, 49]
# (B, H, W, C, O) of wranet's two K8 launches at 256px
SERVED = [(8, 128, 128, 128, 32), (8, 256, 256, 128, 32)]


def _check(p, b, c, o, taps, ho, wo):
    assert p.th * p.tw == k8.PATCH and p.wy * p.wx == p.warps == k8.n_warps(p.nt)
    assert p.ck % 16 == 0 and p.ck <= k8.CK_MAX and p.ck * p.nch >= c > p.ck * (p.nch - 1)
    assert 8 * p.nt >= o and p.nt in (4, 8, 16) and p.warps == (16 if o <= 64 else 8)
    assert 1 <= p.group <= taps and p.resident == (p.group == taps)
    assert p.smem == k8.smem_bytes(p.ck, p.nch, p.group, p.nt) <= k8.SMEM_LIMIT
    assert p.tiles == b * -(-ho // (p.wy * p.th)) * -(-wo // (p.wx * p.tw))
    assert 1 <= p.grid <= min(p.tiles, 132)


def _first_design_took(c, o):
    """The shared memory rule of K8's first design, whose shapes every plan
    must still take: a [64, C + 8] row tile and one [C, O + 8] weight tap
    (C rounded up to 16, O to 16, 32, 64 or 128), within 200 KB."""
    cpad = -(-c // 16) * 16
    nt = max(2, 1 << (-(-o // 8) - 1).bit_length())
    return 2 * (64 * (cpad + 8) + cpad * (8 * nt + 8)) <= 200 * 1024


@pytest.mark.parametrize("c", CHANNELS)
def test_every_shape_has_a_plan_within_shared_memory(c):
    """Every C, O <= 128 and K <= 49 that the first design took fits one
    block, with the largest group of taps whose weights fit; a shape whose
    one tap does not fit is refused."""
    for o in OUTS:
        for taps in TAPS:
            for ho, wo in ((1, 1), (5, 3), (37, 45), (128, 128)):
                if k8.smem_bytes(*k8.chunks(c), 1, k8.n_tiles(o)) > k8.SMEM_LIMIT:
                    assert not _first_design_took(c, o)
                    with pytest.raises(ValueError):
                        k8.plan(2, c, o, taps, ho, wo)
                    continue
                p = k8.plan(2, c, o, taps, ho, wo)
                _check(p, 2, c, o, taps, ho, wo)
                if p.group < taps:
                    assert k8.smem_bytes(p.ck, p.nch, p.group + 1, p.nt) > k8.SMEM_LIMIT


def test_every_shape_the_first_design_took_has_a_plan():
    for c in range(1, 1025):
        for o in (1, 16, 32, 33, 64, 65, 128):
            if _first_design_took(c, o):
                _check(k8.plan(1, c, o, 49, 9, 9), 1, c, o, 49, 9, 9)


@pytest.mark.parametrize("b,h,w,c,o", SERVED)
def test_served_shapes_get_the_named_plan(b, h, w, c, o):
    """wranet's launches: 4 x 4 patches, 16 warps in a 16 x 16 block tile,
    W resident (73.7 KB of weights in 92,160 bytes of padded slots),
    174,080 bytes a block, one block an SM."""
    p = k8.plan(b, c, o, 9, h, w)
    assert (p.th, p.tw, p.wy, p.wx, p.warps) == (4, 4, 4, 4, 16)
    assert (p.ck, p.nch, p.nt, p.group, p.resident) == (128, 1, 4, 9, True)
    assert p.smem == 9 * 128 * 40 * 2 + 16 * 16 * (136 * 2 + 48) == 174080
    assert p.tiles == b * (h // 16) * (w // 16) and p.grid == 132


@pytest.mark.parametrize("wo,patch,block", [(1, (16, 1), (16, 1)), (2, (8, 2), (16, 1)),
                                            (3, (4, 4), (16, 1)), (5, (4, 4), (8, 2)),
                                            (12, (4, 4), (4, 4)), (300, (4, 4), (4, 4))])
def test_default_patch_and_block(wo, patch, block):
    p = k8.plan(1, 16, 8, 9, 9, wo)
    assert ((p.th, p.tw), (p.wy, p.wx)) == (patch, block)
    assert k8.plan(1, 16, 100, 9, 9, wo).wy * 2 == p.wy


@pytest.mark.parametrize("o", [8, 100])
@pytest.mark.parametrize("ho,wo", [(9, 1), (37, 2), (9, 3), (37, 5), (9, 11), (37, 45), (1, 130)])
def test_tiles_cover_every_output_pixel_once(ho, wo, o):
    """patch_pixel's map (csrc/deform.cu): each output pixel of each image
    belongs to exactly one (block tile, warp, p) of the plan, for every
    patch and block layout the plan picks (16 warps, and 8 at O > 64)."""
    b = 2
    p = k8.plan(b, 16, o, 9, ho, wo)
    count = np.zeros((b, ho, wo), np.int32)
    for t in range(p.tiles):
        for warp in range(p.warps):
            for q in range(k8.PATCH):
                img, oy, ox = _patch_pixel(p, ho, wo, t, warp, q)
                if oy < ho and ox < wo:
                    count[img, oy, ox] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("c,o", [(768, 128), (1000, 100), (1920, 32), (8192, 1)])
def test_plan_refuses_a_tap_that_does_not_fit(c, o):
    """One tap's weights beside the warps' row tiles must fit a block; the
    plan and the wrapper's checks refuse the shape otherwise."""
    assert k8.smem_bytes(*k8.chunks(c), 1, k8.n_tiles(o)) > k8.SMEM_LIMIT
    with pytest.raises(ValueError, match="do not fit"):
        k8.plan(1, c, o, 9, 9, 9)


def test_k8_tile_plan_grid_is_one_block_an_sm():
    assert k8.plan(8, 128, 32, 9, 256, 256, sms=114).grid == 114
    assert k8.plan(1, 8, 8, 9, 9, 9, sms=132).grid == 1


def _patch_pixel(p, ho, wo, tile, warp, q):
    tiles_y, tiles_x = -(-ho // (p.wy * p.th)), -(-wo // (p.wx * p.tw))
    img, r = divmod(tile, tiles_y * tiles_x)
    oy = ((r // tiles_x) * p.wy + warp // p.wx) * p.th + q // p.tw
    ox = ((r % tiles_x) * p.wx + warp % p.wx) * p.tw + q % p.tw
    return img, oy, ox


def _emulate(x, offset, mask, weight, bias, stride, pad, dil, p):
    """csrc/deform.cu's schedule in torch, one warp at a time (warps share
    nothing but the weights): the raw values of a tap loaded one tap ahead
    (across tiles too), its samples formed from them, the gather of each
    channel chunk rounded as the kernel rounds it, f32 sums across taps and
    chunks, tap groups, and the epilogue with the bias. The products are f32
    matrix products (the kernel's mma.sync order differs in the last bits)."""
    b, h, w, c = x.shape
    kh, kw, _, o = weight.shape
    taps = kh * kw
    ho, wo = out_size(h, w, kh, kw, stride, pad, dil)
    xf = x.float().reshape(-1, c)
    off = offset.float().reshape(b * ho * wo, taps, 2)
    m = mask.float().reshape(b * ho * wo, taps)
    wk = weight.float().reshape(taps, c, o)
    out = torch.full((b, ho, wo, o), float("nan"))
    q = torch.arange(k8.PATCH)

    def raw(tile, warp, k):
        if tile >= p.tiles:
            return None
        img, oy, ox = _patch_pixel(p, ho, wo, tile, warp, q)
        img = torch.full_like(q, img)
        ok = (oy < ho) & (ox < wo)
        n = (img * ho + oy.clamp(max=ho - 1)) * wo + ox.clamp(max=wo - 1)
        return tile, k, img, oy, ox, ok, off[n, k, 0], off[n, k, 1], m[n, k]

    def form(r):
        tile, k, img, oy, ox, ok, dy, dx, mk = r
        by = (oy * stride - pad + (k // kw) * dil).float()
        bx = (ox * stride - pad + (k % kw) * dil).float()
        py = torch.clamp(by + dy, -1.0, float(h)) + 1.0
        px = torch.clamp(bx + dx, -1.0, float(w)) + 1.0
        y0 = torch.floor(py).clamp(0, h).long()
        x0 = torch.floor(px).clamp(0, w).long()
        wy1, wx1 = py - y0, px - x0
        cw = torch.stack([(1 - wy1) * (1 - wx1) * mk, (1 - wy1) * wx1 * mk,
                          wy1 * (1 - wx1) * mk, wy1 * wx1 * mk], 1) * ok[:, None]
        y, xx = y0 - 1, x0 - 1
        corners = []
        for cy, cx in ((y, xx), (y, xx + 1), (y + 1, xx), (y + 1, xx + 1)):
            inside = ok & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            pix = (img * h + cy.clamp(0, h - 1)) * w + cx.clamp(0, w - 1)
            corners.append(torch.where(inside[:, None], xf[pix], torch.zeros(1, c)))
        return tile, k, cw, corners, img, oy, ox, ok

    for block in range(p.grid):
        for warp in range(p.warps):
            held = raw(block, warp, 0)
            for tile in range(block, p.tiles, p.grid):
                acc = torch.zeros(k8.PATCH, o)
                for k0 in range(0, taps, p.group):
                    slots = {k: wk[k] for k in range(k0, min(taps, k0 + p.group))}
                    for k in slots:
                        tt, kk, cw, corners, img, oy, ox, ok = form(held)
                        assert (tt, kk) == (tile, k)
                        held = raw(tile, warp, k + 1) if k + 1 < taps else raw(
                            tile + p.grid, warp, 0)
                        for j in range(p.nch):
                            ch = slice(j * p.ck, min(c, (j + 1) * p.ck))
                            g = corners[0][:, ch] * cw[:, :1]
                            for qn in range(1, 4):
                                g = g + corners[qn][:, ch] * cw[:, qn:qn + 1]
                            acc = acc + g.to(torch.bfloat16).float() @ slots[k][ch]
                acc = acc + (0 if bias is None else bias.float())
                keep = ok.nonzero()[:, 0]
                out[img[keep], oy[keep], ox[keep]] = acc[keep].to(torch.bfloat16).float()
            assert held is None
    return out.to(torch.bfloat16)


def _case(b, h, w, c, o, k, stride, pad, dil, scale, seed=0):
    rng = np.random.default_rng(seed)
    ho, wo = out_size(h, w, k, k, stride, pad, dil)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    bf = torch.bfloat16
    return (t(b, h, w, c).to(bf), (scale * t(b, ho, wo, 2 * k * k)).to(bf),
            torch.sigmoid(2 * t(b, ho, wo, k * k)).to(bf),
            (t(k, k, c, o) / (k * k * c) ** 0.5).to(bf), t(o).to(bf))


@pytest.mark.parametrize("b,h,w,c,o,k,stride,pad,dil,scale,sms", [
    (2, 9, 11, 20, 5, 3, 1, 1, 1, 3.0, 3),         # ragged tiles
    (1, 12, 10, 200, 40, 3, 1, 1, 1, 1.0, 2),      # two chunks: W in groups of 4 taps
    (2, 13, 2, 24, 16, 5, 2, 2, 1, 8.0, 5),        # stride 2: one column, 16 x 1 patches
    (1, 10, 2, 16, 8, 3, 1, 1, 1, 3.0, 1),         # two columns: 8 x 2 patches
    (1, 11, 11, 16, 100, 3, 1, 2, 2, 0.0, 1),      # dilation 2, 8 warps
])
def test_emulated_schedule_matches_reference(b, h, w, c, o, k, stride, pad, dil, scale, sms):
    args = _case(b, h, w, c, o, k, stride, pad, dil, scale)
    ho, wo = out_size(h, w, k, k, stride, pad, dil)
    p = k8.plan(b, c, o, k * k, ho, wo, sms=sms)
    got = _emulate(*args, stride, pad, dil, p).float()
    ref = k8.deform_conv2d_reference(*args, stride, pad, dil).float()
    assert torch.isfinite(got).all()
    excess = (got - ref).abs() - 2.0 ** -7 * ref.abs()
    assert (excess.max() / ref.pow(2).mean().sqrt()).item() <= 1e-3
