"""K3's host-side plan and the stream instance's order of work (CPU).

The served instance of the CUDA kernel (``csrc/depthwise.cu``,
``depthwise_stream_kernel``) gives a block of 128 threads a chunk of 8 CV
channels and a strip of TW = 128 / CV output columns; the block takes the
items (image, band of BH rows, strip) ``first, first + per_chunk, ...`` of
its chunk and streams their input rows (BH + 2 an item, zero past the
edges) through a ring of slots, each thread adding every row into three
running output rows. The wrapper plans the launch in plain Python
(``ops/kernels/depthwise.py::plan``), so the plan is checked here, and
:func:`emulate` repeats the instance's schedule and f32 arithmetic in PyTorch
to hold it against ``depthwise_conv2d_reference`` at K3's reading, with and
without the source's planted faults. ``tests/test_torch_kernels_cuda.py``
holds the plan against the numbers the built source exports, and the kernel
against the plain version, on the card.
"""

import numpy as np
import pytest
import torch

from unet_zoo_tpu_torch.ops.kernels import depthwise as k3

torch.set_num_threads(1)

SMEM_LIMIT = 232448        # an H100 block's dynamic shared memory
SM_SMEM = 233472           # an H100 SM's shared memory (228 KB)
K3_SHARE = 1e-3            # chip_smoke.py's K3_SHARE
# unext / unext_s at 256px: (H = W, C) of each stage's K3 launch
SERVED = [(64, 512), (32, 640), (16, 1024), (64, 256), (32, 512), (16, 640)]
ODD = [(2, 13, 21, 24), (1, 5, 6, 520), (3, 9, 7, 8), (1, 1, 1, 8), (2, 37, 45, 16),
       (1, 70, 3, 40)]
# missformer at 512px and 256px and unext_moe at 256px (B=8): (H = W, C) of
# each K3 launch shape not in SERVED; the plan gives the bridge's 16x16 and
# 8x8 tokens bands of 2 and 1 rows, and 512px's first stage bands of 64
MISSFORMER = [(128, 256), (32, 1280), (32, 256), (16, 2048), (16, 256), (16, 1280), (8, 2048),
              (8, 256)]


def ulp_reading(got, ref):
    """chip_smoke.py's ulp_reading: the error beyond one bf16 ulp of ref, as
    a share of ref's rms."""
    excess = (got.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
    return (excess.max() / ref.float().pow(2).mean().sqrt()).item()


def block_items(p, blk):
    """The chunk of block ``blk`` and its items as (image, first output row,
    first output column), in the order the block takes them."""
    chunk, first = blk % p.chunks, blk // p.chunks
    items = []
    for item in range(first, p.items, p.per_chunk):
        rest = item // p.strips
        items.append((rest // p.bands, (rest % p.bands) * p.bh, (item % p.strips) * p.tw))
    return chunk, items


def fma(a, b, c):
    """f32 fmaf(a, b, c): the product is exact in float64 (a bf16 value times
    an f32 tap), the sum rounded to f32 once (bar a rare double rounding)."""
    return (a.double() * b.double() + c.double()).float()


def emulate(x, kern, bias, p, fault=None):
    """The stream instance's schedule for x [B, H, W, C] (bf16), laid out as
    ``p``: per block, its stream of input rows reaches a ring of p.ring slots
    p.ring - 1 rows ahead, each into the slot of the row before the one in use
    (the stale-slot fault: each issued after the row in use, which is read
    from the slot of the row before it); each row, read from its slot as the
    columns x - 1,
    x, x + 1 of the strip, is added by fmaf into the row it finishes (taps
    dy = 2; then the bias, one rounding, the store), the middle row (dy = 1)
    and the row it starts (dy = 0). ``fault``: a name of ``k3.FAULTS``.
    Unwritten outputs stay NaN."""
    b_, h, w, c = x.shape
    xf, t = x.float(), kern.float()
    bf = bias.float() if bias is not None else torch.zeros(c)
    out = torch.full((b_, h, w, c), float("nan"))
    span = 8 * p.cv
    for blk in range(p.grid):
        chunk, items = block_items(p, blk)
        c0 = chunk * span
        ch = slice(c0, min(c0 + span, c))
        nch = ch.stop - ch.start
        if nch <= 0:
            continue
        stream = [(item, i) for item in items for i in range(p.bh + 2)]

        def fetch(row):
            (b, y0, x0), i = stream[row]
            gy = y0 - 1 + i
            if fault == "halo row from the neighbouring band":
                gy += -1 if i == 0 else 1 if i == p.bh + 1 else 0
            slot = torch.zeros(p.tw + 2, nch)
            if 0 <= gy < h:
                lo, hi = max(x0 - 1, 0), min(x0 + p.tw + 1, w)
                slot[lo - (x0 - 1):hi - (x0 - 1)] = xf[b, gy, lo:hi, ch]
            return slot

        stale = fault == "stale ring slot"
        ring = [None] * p.ring
        for row in range(min(p.ring - 1, len(stream))):
            ring[row % p.ring] = fetch(row)
        fin, mid, fresh = (torch.zeros(p.tw, nch) for _ in range(3))
        for j, ((b, y0, x0), i) in enumerate(stream):
            ahead = j + p.ring - 1
            if not stale and ahead < len(stream):
                # the slot of row j - 1, which the block barrier has released
                assert ahead % p.ring != j % p.ring
                ring[ahead % p.ring] = fetch(ahead)
            src = ring[(j - 1 if stale and j > 0 else j) % p.ring]
            for dx in range(3):
                v = src[dx:dx + p.tw]
                fin = fma(v, t[2, dx, ch], fin)
                mid = fma(v, t[1, dx, ch], mid)
                fresh = v * t[0, dx, ch] if dx == 0 else fma(v, t[0, dx, ch], fresh)
            y = y0 + i - 2
            if i >= 2 and y < h:
                cols = min(p.tw, w - x0)
                out[b, y, x0:x0 + cols, ch] = fin[:cols] + bf[ch]
            if stale and ahead < len(stream):
                ring[ahead % p.ring] = fetch(ahead)
            fin, mid, fresh = mid, fresh, fin
    return out.to(x.dtype)


def case(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed + b * 1000 + h * 37 + w * 11 + c)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return (bf(rng.standard_normal((b, h, w, c))), bf(rng.standard_normal((3, 3, c)) / 3),
            bf(rng.standard_normal(c)))


PLAN_CASES = (sorted({(b, hw, hw, c) for b in range(1, 9) for hw, c in SERVED}) + ODD
              + [(8, hw, hw, c) for hw, c in MISSFORMER])


@pytest.mark.parametrize("b,h,w,c", PLAN_CASES)
def test_plan_covers_every_output_once(b, h, w, c):
    """Every (image, row, column, channel vector) is written by exactly one
    thread of one block; the layout is the source's (``layout``)."""
    p = k3.plan(b, h, w, c)
    assert p == k3.layout(b, h, w, c, p.lcv, p.bh, p.ring)
    assert p.cv in (4, 8, 16) and p.tw * p.cv == k3.STREAM_THREADS == p.threads
    assert p.ring in k3.RINGS
    assert p.grid == p.chunks * p.per_chunk and 1 <= p.per_chunk <= p.items
    count = np.zeros((b, h, w, p.chunks * p.cv), np.int32)
    for blk in range(p.grid):
        chunk, items = block_items(p, blk)
        for im, y0, x0 in items:
            count[im, y0:y0 + p.bh, x0:x0 + p.tw, chunk * p.cv:(chunk + 1) * p.cv] += 1
    assert (count[..., :c // 8] == 1).all()
    assert p.tw <= max(w, 8)


@pytest.mark.parametrize("hw,c", SERVED)
def test_plan_fills_the_sms(hw, c):
    """At every served launch shape and B = 1..8 the grid has a block for
    each of the 132 SMs, and at most one wave of resident blocks."""
    for b in range(1, 9):
        p = k3.plan(b, hw, hw, c)
        assert p.grid >= k3.SMS, (b, p)
        assert p.grid <= k3.SMS * k3.BLOCKS_PER_SM + p.chunks, (b, p)


@pytest.mark.parametrize("b,h,w,c", PLAN_CASES)
def test_plan_shared_memory(b, h, w, c):
    """A block's ring and bias fit the 227 KB limit, and the blocks an SM
    the plan counts on fit its 228 KB."""
    p = k3.plan(b, h, w, c)
    assert p.smem == p.ring * (p.tw + 2) * p.cv * 16 + p.cv * 32
    assert p.smem <= SMEM_LIMIT and k3.BLOCKS_PER_SM * (p.smem + 1024) <= SM_SMEM


def test_plan_refuses_what_the_stream_instance_does_not_take():
    for shape in ((2, 8, 8, 20), (2, 8, 8, 0), (0, 8, 8, 16)):
        with pytest.raises(ValueError, match="no stream plan"):
            k3.plan(*shape)


def test_instance_by_type_kernel_size_channels_and_alignment():
    """bf16, k = 3, C % 8 == 0 and 16-byte aligned x and kernel take the
    stream instance; float32, k 5 or 7, C 20, x or the kernel off 16 bytes
    the general one."""
    x = torch.zeros(2, 8, 8, 16, dtype=torch.bfloat16)
    kern = torch.zeros(3, 3, 16, dtype=torch.bfloat16)
    assert k3.instance(x, kern) == "stream"
    assert k3.instance(x.float(), kern.float()) == "general"
    assert k3.instance(x, torch.zeros(5, 5, 16, dtype=torch.bfloat16)) == "general"
    assert k3.instance(x, torch.zeros(7, 7, 16, dtype=torch.bfloat16)) == "general"
    assert k3.instance(torch.zeros(2, 8, 8, 20, dtype=torch.bfloat16),
                       torch.zeros(3, 3, 20, dtype=torch.bfloat16)) == "general"
    off = torch.zeros(2 * 8 * 8 * 16 + 8, dtype=torch.bfloat16)[8:].view(2, 8, 8, 16)
    assert off.data_ptr() % 16 == 0 and k3.instance(off, kern) == "stream"
    off = torch.zeros(2 * 8 * 8 * 16 + 4, dtype=torch.bfloat16)[4:].view(2, 8, 8, 16)
    assert k3.instance(off, kern) == "general"
    kern_off = torch.zeros(9 * 16 + 4, dtype=torch.bfloat16)[4:].view(3, 3, 16)
    assert k3.instance(x, kern_off) == "general"


# (B, H, W, C, layout overrides): the plan's own layouts at served-like and
# odd shapes, and layouts with several items a block (the stream crossing
# items), partial last bands and strips, every ring and chunk width
EMULATED = [
    (2, 16, 16, 64, {}), (2, 8, 8, 128, {}), (1, 13, 21, 24, {}), (1, 5, 6, 520, {}),
    (3, 9, 7, 8, {}), (1, 1, 1, 8, {}),
    (2, 12, 40, 32, dict(lcv=2, bh=5, ring=3, per_chunk=3)),
    (2, 11, 17, 64, dict(lcv=3, bh=4, ring=4, per_chunk=2)),
    (1, 10, 9, 136, dict(lcv=4, bh=3, ring=6, per_chunk=1)),
    (3, 7, 33, 16, dict(lcv=2, bh=2, ring=6, per_chunk=5)),
] + [(8, hw, hw, c, {}) for hw, c in MISSFORMER]


def _layout(b, h, w, c, over):
    if not over:
        return k3.plan(b, h, w, c)
    return k3.layout(b, h, w, c, over["lcv"], over["bh"], over["ring"],
                     per_chunk=over["per_chunk"])


@pytest.mark.parametrize("b,h,w,c,over", EMULATED)
def test_emulated_stream_matches_reference(b, h, w, c, over):
    """The instance's schedule in f32, held against the plain version at
    K3's bar; every output written."""
    x, kern, bias = case(b, h, w, c)
    p = _layout(b, h, w, c, over)
    got = emulate(x, kern, bias, p)
    assert not torch.isnan(got.float()).any()
    ref = k3.depthwise_conv2d_reference(x, kern, bias)
    assert ulp_reading(got, ref) <= K3_SHARE
    nobias = emulate(x, kern, None, p)
    assert ulp_reading(nobias, k3.depthwise_conv2d_reference(x, kern)) <= K3_SHARE


@pytest.mark.parametrize("b,h,w,c,over", [e for e in EMULATED if e[1] > 2])
def test_emulated_planted_faults_read_above_the_bar(b, h, w, c, over):
    """The source's planted faults, in the same emulation, read above K3's
    bar: a band's halo rows read one row inside the neighbouring band (where
    the layout has more than one band), each row computed from the ring slot
    of the row before it."""
    x, kern, bias = case(b, h, w, c, seed=1)
    p = _layout(b, h, w, c, over)
    ref = k3.depthwise_conv2d_reference(x, kern, bias)
    faults = ["stale ring slot"] + (["halo row from the neighbouring band"] if p.bands > 1 else [])
    for fault in faults:
        assert ulp_reading(emulate(x, kern, bias, p, fault), ref) > K3_SHARE, fault


def test_missformer_plans_reach_thin_and_tall_bands():
    """The launch shapes added for missformer and unext_moe take the plan's
    extreme band heights, which the emulation above covers: one-row bands
    (each band reads 3 input rows for 1 output row) at [8, 8, 8, 256],
    two-row bands at [8, 16, 16, 256], 64-row bands at [8, 128, 128, 256]."""
    bh = {(hw, c): k3.plan(8, hw, hw, c).bh for hw, c in MISSFORMER}
    assert bh[(8, 256)] == 1 and bh[(16, 256)] == 2 and bh[(128, 256)] == 64
    for hw, c in MISSFORMER:
        p = k3.plan(8, hw, hw, c)
        assert p.bands * p.bh >= hw and p.strips * p.tw >= hw


def test_served_plans_stream_bands_of_rows():
    """At the served shapes (B=8) the plan streams bands of several rows
    (each input row read once a band, not once an 8-row tile), with rows in
    flight across the ring, and widens strips where the image allows."""
    for hw, c in SERVED:
        p = k3.plan(8, hw, hw, c)
        assert p.bh >= 3 and p.ring - 1 >= 2
        assert p.tw == min(32, hw)
