"""The port's CUDA kernels (K1-K8, P1, P2) against their plain PyTorch
versions, and each model's kernel path against its plain path, on the card.

These need an NVIDIA GPU (sm_90a) and ``nvcc``: a CUDA kernel has no CPU
mode, so every test here skips without a card. The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies::

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.medt_net import AxialAttention
from unet_zoo_tpu_torch.models.mmunet import MKBlock
from unet_zoo_tpu_torch.models.swin_unet_v2 import SwinBlockV2, WindowAttentionV2
from unet_zoo_tpu_torch.models.wranet import DeformableConv
from unet_zoo_tpu_torch.nn import init_weights
from unet_zoo_tpu_torch.ops.kernels import axial_attention as k6
from unet_zoo_tpu_torch.ops.kernels import build
from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2
from unet_zoo_tpu_torch.ops.kernels import row_gather as p1
from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
from unet_zoo_tpu_torch.ops.kernels import deform as k8
from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
from unet_zoo_tpu_torch.ops.kernels import morph as k5
from unet_zoo_tpu_torch.ops.kernels import window_attention as k2
from unet_zoo_tpu_torch.utils.serving import calibrate_int8, make_predictor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(gen, device, b, hc, wc, cin, cu, cs, co):
    n = lambda *s: torch.randn(*s, generator=gen, device=device)
    cl = torch.channels_last
    bf = torch.bfloat16
    return (n(b, cin, hc, wc).to(bf).contiguous(memory_format=cl),
            n(b, cs, 2 * hc, 2 * wc).to(bf).contiguous(memory_format=cl),
            (n(cin, 4 * cu) / cin ** 0.5).to(bf), n(cu) * 0.1,
            (n(9 * (cu + cs), co) / (9 * (cu + cs)) ** 0.5).to(bf),
            1.0 + 0.2 * n(co), 0.1 * n(co))


# K1: each grid against its half of the plain version on the same bf16
# operands, the error beyond one bf16 ulp as a share of the output's rms
# (chip_smoke.py's K1_SHARE and ulp_reading); the whole against the plain
# version in f32 keeps the parent's bar, 1e-2 (1 + max |ref|).
K1_SHARE = 1e-3
K1_CASES = [
    (2, 8, 8, 128, 64, 64, 64),     # unet's last stage, narrow
    (1, 8, 12, 96, 64, 32, 48),     # non-square, Co != Cu
    (3, 5, 7, 64, 32, 32, 40),      # ragged M and N tiles
    (8, 16, 16, 1024, 512, 512, 512),   # unet's four served stages, B=8 256px
    (8, 32, 32, 512, 256, 256, 256),
    (8, 64, 64, 256, 128, 128, 128),
    (8, 128, 128, 128, 64, 64, 64),
    (1, 4, 6, 64, 32, 32, 16),      # Cu = Cs = 32, B = 1
    (2, 9, 13, 160, 96, 64, 96),    # Cu 96: a chunk past the end of up
    (1, 3, 2, 32, 32, 32, 8),       # 16 x 8 tiles, Co 8
]


def _ulp_reading(got, ref):
    excess = (got.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
    return (excess.max() / ref.float().pow(2).mean().sqrt()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,hc,wc,cin,cu,cs,co", K1_CASES)
def test_fused_up_kernel_matches_reference(cuda_device, b, hc, wc, cin, cu, cs, co):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    args = _case(gen, cuda_device, b, hc, wc, cin, cu, cs, co)
    y, skip, wt, bt, wc_, sc, bi = args
    ref = k1.fused_up_concat_conv_reference(*[a.float() for a in args])
    got = k1.fused_up_concat_conv(*args)
    up, staged = k1.kernel_stages(*args)
    up2, again = k1.kernel_stages(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - ref).abs().max().item()
    assert err <= 1e-2 * (1 + ref.abs().max().item()), err
    assert torch.equal(got, staged) and torch.equal(staged, again) and torch.equal(up, up2)
    assert _ulp_reading(up, k1.convt_reference(y, wt, bt)) <= K1_SHARE
    assert _ulp_reading(got, k1.conv_reference(up, skip, wc_, sc, bi)) <= K1_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(k1.FAULTS))
@pytest.mark.parametrize("b,hc,wc,cin,cu,cs,co", [K1_CASES[i] for i in (1, 2, 6, 7)])
def test_fused_up_planted_faults_are_rejected(cuda_device, fault, b, hc, wc, cin, cu, cs, co):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    args = _case(gen, cuda_device, b, hc, wc, cin, cu, cs, co)
    up, _ = k1.kernel_stages(*args)
    ref = k1.conv_reference(up, args[1], *args[4:])
    before = k1.LAUNCHES["fused_up_concat_conv"]
    got = k1.kernel_stages(*args, fault=fault)[1]
    torch.cuda.synchronize()
    assert k1.LAUNCHES["fused_up_concat_conv"] == before
    assert _ulp_reading(got, ref) > K1_SHARE


@pytest.mark.cuda
def test_fused_up_plan_matches_source(cuda_device):
    for tile in k1.SOURCE_TILES:
        assert k1.source_geometry(*tile) == k1.ring(*tile), tile
    for b, hc, wc, cin, cu, cs, co in K1_CASES:
        p = k1.plan(b, hc, wc, cin, cu, cs, co)
        assert (1, p.bn, 1) in k1.SOURCE_TILES and (0, 128, p.convt_ctas) in k1.SOURCE_TILES


@pytest.mark.cuda
def test_unet_kernel_path_raises_without_its_kernel(cuda_device, monkeypatch):
    # no fallback: a refused launch or a library that does not load makes
    # the served forward raise, never run the plain version
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    pred = make_predictor(create_model("unet", dtype=torch.bfloat16), None, "logits")

    class Refusing:
        def fused_up_forward(self, *a):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(k1, "_lib", lambda: Refusing())
    with pytest.raises(RuntimeError, match="fused_up launch failed"):
        pred(x)

    def missing(stem):
        raise RuntimeError(f"nvcc failed for {stem}")

    monkeypatch.setattr(k1, "_lib", lambda: build.library("fused_up"))
    monkeypatch.setattr(build, "library", missing)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pred(x)


@pytest.mark.cuda
def test_unet_kernel_path_matches_plain_path(cuda_device):
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    preds = [make_predictor(create_model("unet", dtype=torch.bfloat16, use_kernels=k),
                            None, "logits") for k in (None, False)]
    before = k1.LAUNCHES["fused_up_concat_conv"]
    got = preds[0](x).float()
    assert k1.LAUNCHES["fused_up_concat_conv"] - before == 4
    ref = preds[1](x).float()
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2


# K4: the error beyond the output's bf16 rounding (half an ulp, 2^-8 |ref|)
# may be at most this share of the MLP branch's rms; it comes from h0 and
# hidden elements that kernel and plain version round to neighbouring bf16
# values (chip_smoke.py's k4_reading, with the same limit).
K4_BRANCH_SHARE = 2e-2
# K5, relative: half a bf16 ulp plus f32 differences of exp and the sum.
K5_REL = 2.0 ** -8 + 2.0 ** -16


def _k4_reading(got, ref, x):
    excess = (got.float() - ref).abs() - 2.0 ** -8 * ref.abs()
    return (excess.max() / (ref - x.float()).pow(2).mean().sqrt()).item()


def _k5_reading(got, ref):
    return ((got.float() - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()


def _mkblock_weights(device, c, seed=0):
    """A random MKBlock with BN and biases off identity, folded."""
    blk = MKBlock(c)
    init_weights(blk, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
                m.running_var.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(2))
            elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(3))
    return [t.to(device) for t in k4.fold_mkblock_params(blk.eval())]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w", [
    (2, 96, 30, 31),       # first_down's width (fused MLP grid), M not a multiple of 128
    (1, 192, 20, 12),      # down0's width (fused MLP grid), one partial row tile
    (1, 768, 8, 8),        # down3's width (two GEMM grids), one tile
    (1, 32, 13, 21),       # ragged tiles, q = 8
    (2, 64, 5, 70),        # q = 16: two chunks of channel chains, one row of tiles
    (1, 96, 5, 7),         # M below one 128-row MLP tile
    (1, 96, 61, 277),      # M = 132 x 128 + 1: one more than a persistent wave (resident weights)
    (1, 192, 61, 277),     # the same, weights streamed
    (8, 384, 8, 8),        # M = 512: the second GEMM split over K
    (8, 768, 8, 8),
    (2, 160, 12, 20),      # a multiple of 32 outside mmunet's widths: a 64-byte K box
])
def test_fused_mkblock_kernel_matches_reference(cuda_device, b, c, h, w):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    weights = _mkblock_weights(cuda_device, c)
    x = torch.randn(b, c, h, w, generator=gen, device=cuda_device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    ref = k4.fused_mkblock_reference(x.float(), *weights)
    got = k4.fused_mkblock(x, *weights)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    assert _k4_reading(got, ref, x) <= K4_BRANCH_SHARE
    # an output that left out the MLP branch at the image border fails it
    broken = got.clone()
    broken[:, :, 0] = x[:, :, 0]
    assert _k4_reading(broken, ref, x) > K4_BRANCH_SHARE


def _mkblock_input(device, b, c, h, w, seed):
    x = torch.randn(b, c, h, w, generator=torch.Generator(device=device).manual_seed(seed),
                    device=device)
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


# one shape of each form: resident fused MLP, streamed fused MLP, two GEMM
# grids, the second split over K
K4_FORMS = [(8, 96, 24, 24), (2, 192, 24, 24), (8, 384, 32, 32), (8, 768, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w", K4_FORMS)
def test_fused_mkblock_is_deterministic(cuda_device, b, c, h, w):
    """Two launches on the same inputs agree bit for bit: every sum, the
    split second GEMM's too, is taken in a fixed order."""
    weights = _mkblock_weights(cuda_device, c)
    packed = k4.pack_mkblock_weights(weights[2], weights[4])
    x = _mkblock_input(cuda_device, b, c, h, w, 1)
    first = k4.fused_mkblock(x, *weights, packed=packed)
    second = k4.fused_mkblock(x, *weights, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("b,c,h,w", K4_FORMS)
def test_fused_mkblock_interleaved_blocks(cuda_device, streams, b, c, h, w):
    """Two MKBlocks of one width with different weights and inputs, launched
    in turns on one stream or on two streams at once, each give what they give
    alone, bit for bit: no weights, tensor map or workspace of one call is
    served to another."""
    blocks = [_mkblock_weights(cuda_device, c, seed) for seed in (0, 1)]
    packs = [k4.pack_mkblock_weights(wt[2], wt[4]) for wt in blocks]
    xs = [_mkblock_input(cuda_device, b, c, h, w, seed) for seed in (2, 3)]
    alone = [k4.fused_mkblock(x, *wt, packed=pk) for x, wt, pk in zip(xs, blocks, packs)]
    torch.cuda.synchronize()
    for x, wt, got in zip(xs, blocks, alone):
        assert _k4_reading(got, k4.fused_mkblock_reference(x.float(), *wt), x) <= K4_BRANCH_SHARE
    side = [torch.cuda.Stream() for _ in range(streams)]
    outs = [[], []]
    start = torch.cuda.Event()
    start.record()
    for i, st in enumerate(side):
        st.wait_event(start)
    for _ in range(3):
        for i in (0, 1):
            with torch.cuda.stream(side[i % streams]):
                if streams == 2:
                    torch.cuda._sleep(10000)   # let the other stream's launch run meanwhile
                outs[i].append(k4.fused_mkblock(xs[i], *blocks[i], packed=packs[i]))
    torch.cuda.synchronize()
    for i in (0, 1):
        for got in outs[i]:
            assert torch.equal(got, alone[i])
    assert not torch.equal(alone[0], alone[1])


@pytest.mark.cuda
def test_mkblock_plan_matches_the_source(cuda_device):
    """The wrapper's mirror of the fused form's layout is the source's."""
    lib = k4._lib()
    for c in range(32, k4.FUSED_MAX_C + 1, 32):
        resident, smem = k4.fused_layout(c)
        assert (lib.mkblock_fused_resident(c), lib.mkblock_fused_smem(c)) == (int(resident), smem)
    assert lib.mkblock_fused_smem(k4.FUSED_MAX_C + 32) == 0


def _morph_input(device, b, c, h, w, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (2 * torch.randn(b, c, h, w, generator=gen, device=device)).to(torch.bfloat16)
    return x.contiguous(memory_format=torch.channels_last)


# mmunet's five gate shapes at B=8 (base 96, 256px), then odd shapes
MORPH_CASES = [
    (8, 768, 16, 16, 7, 2),
    (8, 384, 32, 32, 7, 2),
    (8, 192, 64, 64, 7, 2),
    (8, 192, 128, 128, 7, 2),
    (8, 96, 256, 256, 7, 1),
    (2, 192, 64, 64, 7, 2),
    (1, 768, 16, 16, 7, 2),
    (2, 96, 40, 24, 7, 1),
    (1, 24, 13, 29, 7, 2),     # ragged tiles
    (3, 16, 9, 9, 7, 1),       # an image smaller than the halo
    (1, 8, 13, 29, 7, 2),
    (8, 64, 64, 64, 7, 1),     # statistics: 8 lanes a pixel
    (8, 128, 64, 64, 7, 1),    # statistics: 16 lanes a pixel
    (1, 40, 33, 100, 7, 2),    # 5 vectors a pixel: statistics 1 lane a pixel
    (2, 176, 64, 64, 7, 2),    # no block of MIN_CB channels or more fits
    (2, 208, 64, 64, 7, 2),
    (2, 232, 64, 64, 7, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,k,repeat", MORPH_CASES)
def test_fused_softmax_morph_kernel_matches_reference(cuda_device, b, c, h, w, k, repeat):
    x = _morph_input(cuda_device, b, c, h, w)
    d_ref, e_ref = k5.fused_softmax_morph_reference(x.float(), k, repeat)
    d, e = k5.fused_softmax_morph(x, k, repeat)
    torch.cuda.synchronize()
    for got, ref in ((d, d_ref), (e, e_ref)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
        assert _k5_reading(got, ref) <= K5_REL
    # an erosion of zeros, or one of the wrong window, fails the same comparison
    assert _k5_reading(torch.zeros_like(e), e_ref) > K5_REL
    assert _k5_reading(k5.fused_softmax_morph_reference(x.float(), 5, repeat)[1], e_ref) > K5_REL
    # two launches agree bit for bit
    d2, e2 = k5.fused_softmax_morph(x, k, repeat)
    assert torch.equal(d, d2) and torch.equal(e, e2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,k,repeat", MORPH_CASES)
def test_morph_plan_matches_the_source(cuda_device, b, c, h, w, k, repeat):
    """The source launches the grid, threads, shared memory and statistics
    blocks that morph.plan computes."""
    p = k5.plan(b, c, h, w, repeat)
    assert k5.source_geometry(b, c, h, w, repeat, p) == (
        *p.grid, p.threads, p.smem, p.stats_blocks, p.rows)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,repeat", [(2, 96, 256, 256, 1), (2, 192, 128, 128, 2),
                                            (2, 192, 64, 64, 2)])
@pytest.mark.parametrize("side", ["strip", "band"])
def test_morph_halo_one_pixel_short_is_rejected(cuda_device, b, c, h, w, repeat, side):
    """The kernel built with a strip or band halo one pixel short of
    R = 3 * repeat (the source's fault entry): the cells beside a strip or
    band inside the image drop out of the windows, and the K5 comparison
    rejects it."""
    x = _morph_input(cuda_device, b, c, h, w, seed=1)
    p = k5.plan(b, c, h, w, repeat)
    assert (-(-w // p.tw) if side == "strip" else -(-h // p.bh)) > 1
    d_ref, e_ref = k5.fused_softmax_morph_reference(x.float(), 7, repeat)
    d, e = k5.short_halo_fault(x, repeat, side)
    torch.cuda.synchronize()
    assert min(_k5_reading(d, d_ref), _k5_reading(e, e_ref)) > K5_REL


def _repad_fault(x, pad_d, pad_e):
    """K5's plain version, two rounds, with the second round padded with
    ``pad_d`` (d) and ``pad_e`` (e) instead of -inf and +inf."""
    F = torch.nn.functional
    sm = torch.softmax(x, dim=1)
    d, e = F.max_pool2d(sm, 7, 1, 3), -F.max_pool2d(-sm, 7, 1, 3)
    d = F.max_pool2d(F.pad(d, (3, 3, 3, 3), value=pad_d), 7, 1)
    e = -F.max_pool2d(F.pad(-e, (3, 3, 3, 3), value=-pad_e), 7, 1)
    return d.to(torch.bfloat16), e.to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("pad_d,pad_e,rejects", [
    (0.0, 0.0, "e"),                             # the second round padded with zeros
    (float("inf"), -float("inf"), "de"),         # the two maps' pads swapped
])
def test_morph_second_round_repad_fault_is_rejected(cuda_device, pad_d, pad_e, rejects):
    """A second round padded with the wrong value fails the K5 comparison
    where the value can win a window (0 in an erosion; +inf in a dilation,
    -inf in an erosion); the kernel passes it. A second round with no
    re-pad at all computes the reference itself
    (tests/test_torch_morph_plan.py), so it is no fault to plant."""
    x = _morph_input(cuda_device, 2, 192, 64, 64, seed=2)
    d_ref, e_ref = k5.fused_softmax_morph_reference(x.float(), 7, 2)
    d_bad, e_bad = _repad_fault(x.float(), pad_d, pad_e)
    reading = {"d": _k5_reading(d_bad, d_ref), "e": _k5_reading(e_bad, e_ref)}
    assert all(reading[m] > K5_REL for m in rejects), reading
    d, e = k5.fused_softmax_morph(x, 7, 2)
    torch.cuda.synchronize()
    assert max(_k5_reading(d, d_ref), _k5_reading(e, e_ref)) <= K5_REL


@pytest.mark.cuda
def test_mmunet_kernel_path_matches_plain_path(cuda_device):
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    preds = [make_predictor(create_model("mmunet", dtype=torch.bfloat16, base_channels=32,
                                         use_kernels=k), None, "logits") for k in (None, False)]
    before = (k4.LAUNCHES["fused_mkblock"], k5.LAUNCHES["fused_softmax_morph"])
    got = preds[0](x).float()
    after = (k4.LAUNCHES["fused_mkblock"], k5.LAUNCHES["fused_softmax_morph"])
    assert (after[0] - before[0], after[1] - before[1]) == (22, 6)
    ref = preds[1](x).float()
    assert torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= 3e-2


@pytest.mark.cuda
def test_mmunet_float32_model_runs_kernels(cuda_device):
    """use_kernels=True on a float32 model: K4 and K5 run on bf16 copies of
    each block's and gate's input and hand back float32."""
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    preds = [make_predictor(create_model("mmunet", dtype=torch.float32, base_channels=32,
                                         use_kernels=k), None, "logits") for k in (True, False)]
    before = (k4.LAUNCHES["fused_mkblock"], k5.LAUNCHES["fused_softmax_morph"])
    got = preds[0](x)
    after = (k4.LAUNCHES["fused_mkblock"], k5.LAUNCHES["fused_softmax_morph"])
    assert (after[0] - before[0], after[1] - before[1]) == (22, 6)
    ref = preds[1](x)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= 3e-2


# K6: the error beyond the output's bf16 rounding (2^-8 |ref|) as a share of
# the output's rms (chip_smoke.py's k6_reading, with the same limit).
K6_SHARE = 1e-3


def _k6_reading(got, ref):
    excess = (got.float() - ref).abs() - 2.0 ** -8 * ref.abs()
    return (excess.max() / ref.pow(2).mean().sqrt()).item()


def _k6_case(device, b, h, w, gp, ks, wopos, g=8):
    gen = torch.Generator(device=device).manual_seed(0)
    u = lambda *s: 0.5 + torch.rand(*s, generator=gen, device=device)
    qkv = torch.randn(b, 2 * g * gp, h, w, generator=gen, device=device).to(torch.bfloat16)
    relative = None if wopos else (torch.randn(2 * gp, 2 * ks - 1, generator=gen, device=device)
                                   / gp ** 0.5)
    sim_scale, out_scale = u(3, g), u(2, g, gp)
    if wopos:
        sim_scale[1:] = 0.0
        out_scale[1] = 0.0
    return (qkv.contiguous(memory_format=torch.channels_last), relative, sim_scale, out_scale,
            0.1 * torch.randn(g, gp, generator=gen, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,gp,ks,wopos,width_axis", [
    (2, 128, 128, 2, 128, False, False),   # gated layer1 (group split 2)
    (2, 64, 64, 8, 64, False, True),       # layer3_0, along W
    (4, 32, 32, 16, 32, False, False),     # layer4_0: the largest reduce-scatter
    (1, 29, 37, 4, 40, False, False),      # L = 29 < ks = 40: the ks - 1 offset
    (2, 16, 16, 4, 16, True, True),        # wopos
    (1, 3, 250, 8, 256, True, True),       # 8 keys per lane
    (2, 64, 64, 32, 64, False, True),      # gp 32: groups=4 or width_per_group=128
    (1, 4, 512, 2, 512, False, True),      # 16 keys per lane: image_size 1024's layer1
    (1, 2, 300, 32, 300, True, True),      # wopos, gp 32, 10 keys per lane
    (2, 33, 5, 4, 33, False, False),       # L = 33: a partial key tile, two query chunks
    (1, 7, 127, 2, 127, False, True),      # L = 127: a partial key tile
    (1, 129, 3, 8, 129, False, False),     # L = 129: a partial tile at R = 2, three chunks
    (1, 3, 128, 2, 128, False, True),      # gp 2 to 32 at L = 128
    (1, 3, 128, 4, 128, False, True),
    (1, 3, 128, 8, 128, False, True),
    (1, 3, 128, 16, 128, False, True),
    (1, 3, 128, 32, 128, False, True),
])
def test_fused_axial_attention_kernel_matches_reference(cuda_device, b, h, w, gp, ks, wopos,
                                                        width_axis):
    args = _k6_case(cuda_device, b, h, w, gp, ks, wopos)
    f32 = [None if a is None else a.float() for a in args]
    ref = k6.fused_axial_attention_reference(*f32, ks, width_axis)
    got = k6.fused_axial_attention(*args, ks, width_axis)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    assert _k6_reading(got, ref) <= K6_SHARE
    if not wopos:
        # the output without the sve term, or with the k embedding read
        # untransposed (the k rows of relative reversed), fails the comparison
        no_sve = f32[:3] + [torch.stack([f32[3][0], torch.zeros_like(f32[3][1])]), f32[4]]
        assert _k6_reading(k6.fused_axial_attention_reference(*no_sve, ks, width_axis),
                           ref) > K6_SHARE
        k_flat = f32[1].clone()
        k_flat[gp // 2:gp] = f32[1][gp // 2:gp].flip(-1)
        assert _k6_reading(k6.fused_axial_attention(args[0], k_flat, *args[2:], ks,
                                                    width_axis), ref) > K6_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,gp,ks,wopos,width_axis", [
    (8, 128, 128, 4, 128, False, True),    # gated layer1_0
    (8, 32, 32, 8, 32, False, False),      # 2 key splits
    (1, 33, 5, 2, 33, True, False),        # wopos, a partial key tile
])
def test_fused_axial_attention_is_deterministic(cuda_device, b, h, w, gp, ks, wopos,
                                                width_axis):
    """Two launches on the same operands agree bit for bit."""
    args = _k6_case(cuda_device, b, h, w, gp, ks, wopos)
    first = k6.fused_axial_attention(*args, ks, width_axis)
    assert torch.equal(first, k6.fused_axial_attention(*args, ks, width_axis))


@pytest.mark.cuda
@pytest.mark.parametrize("fault,b,h,w,gp,ks", [
    ("rescale skipped", 8, 128, 128, 4, 128),
    ("rescale skipped", 8, 64, 64, 8, 64),
    ("partial key tile dropped", 2, 33, 5, 4, 33),
    ("partial key tile dropped", 1, 129, 3, 8, 129),
    ("key-split merge dropped", 8, 64, 64, 4, 64),
    ("key-split merge dropped", 8, 32, 32, 8, 32),
])
def test_fused_axial_attention_design_faults_are_rejected(cuda_device, fault, b, h, w, gp, ks):
    """Faults of the kernel's design, planted through the source's test-only
    entry, fail the K6 comparison; the served kernel passes it on the same
    operands. The similarity is scaled 6x so that rows' references move."""
    args = list(_k6_case(cuda_device, b, h, w, gp, ks, False))
    args[2] = 6.0 * args[2]
    f32 = [a.float() for a in args]
    ref = k6.fused_axial_attention_reference(*f32, ks, False)
    assert _k6_reading(k6.fused_axial_attention(*args, ks, False), ref) <= K6_SHARE
    before = k6.LAUNCHES["fused_axial_attention"]
    got = k6.planted_fault(*args, ks, False, fault)
    torch.cuda.synchronize()
    assert k6.LAUNCHES["fused_axial_attention"] == before
    assert not _k6_reading(got, ref) <= K6_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("gp", k6.GROUP_PLANES)
def test_axial_plan_matches_the_source(cuda_device, gp):
    """plan()'s shared memory is the source's, at every length class."""
    for length in (1, 29, 32, 33, 64, 127, 128, 129, 256, 300, 512):
        for wopos in (False, True):
            for gb in (1, 2, 8):
                assert (k6.source_smem(length, gp, gb, wopos)
                        == k6.smem_bytes(length, gp, gb, wopos))


@pytest.mark.cuda
def test_axial_attention_outside_kernel_shapes_raises(cuda_device):
    """No shape gate: a bf16 block on the card whose shape K6 does not take
    raises instead of running the module path; use_kernels=False serves it."""
    for gp, length in ((6, 32), (32, 512)):      # gp not built; shared memory too small
        attn = AxialAttention(8 * gp, 8 * gp, 8, length, width_axis=True, mode="gated",
                              dtype=torch.bfloat16)
        init_weights(attn, torch.Generator().manual_seed(0))
        attn = attn.to(cuda_device).eval()
        x = torch.randn(1, 8 * gp, 2, length, device=cuda_device).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        before = k6.LAUNCHES["fused_axial_attention"]
        with torch.no_grad(), pytest.raises(ValueError, match="use_kernels=False"):
            attn(x)
        assert k6.LAUNCHES["fused_axial_attention"] == before
        attn.use_kernels = False
        with torch.no_grad():
            assert torch.isfinite(attn(x).float()).all()


@pytest.mark.cuda
def test_gated_registry_kwargs_run_kernel(cuda_device):
    """create_model('gated', groups=4): layer4's gp is 32, which K6 takes."""
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    preds = [make_predictor(create_model("gated", dtype=torch.bfloat16, image_size=64, groups=4,
                                         use_kernels=k), None, "logits") for k in (None, False)]
    before = k6.LAUNCHES["fused_axial_attention"]
    got = preds[0](x).float()
    assert k6.LAUNCHES["fused_axial_attention"] - before == 16
    ref = preds[1](x).float()
    assert torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-1


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [("gated", 16), ("medt", 16), ("medt_logo", 22)])
def test_medt_kernel_path_matches_plain_path(cuda_device, name, launches):
    """chip_smoke.py's limits for the small MedT forwards: relative L2 of
    the bf16 paths <= 1e-1, and the kernel path no farther from float32
    compute than 1.25x the plain path (the plain path rounds the
    similarity logits to bf16)."""
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    preds = [make_predictor(create_model(name, dtype=dt, image_size=64, use_kernels=k), None,
                            "logits")
             for dt, k in ((torch.bfloat16, None), (torch.bfloat16, False), (torch.float32, False))]
    before = k6.LAUNCHES["fused_axial_attention"]
    got = preds[0](x).float()
    assert k6.LAUNCHES["fused_axial_attention"] - before == launches
    ref, exact = preds[1](x).float(), preds[2](x).float()
    assert torch.isfinite(got).all()
    dist = lambda a, b: ((a - b).norm() / b.norm()).item()
    assert dist(got, ref) <= 1e-1
    assert dist(got, exact) <= 1.25 * dist(ref, exact)


@pytest.mark.cuda
def test_axial_attention_float32_runs_kernel(cuda_device):
    """use_kernels=True on a float32 module: K6 runs on a bf16 copy of the
    projections and hands back float32."""
    attn = AxialAttention(16, 16, 8, 32, stride=2, width_axis=True, mode="gated",
                          use_kernels=True)
    init_weights(attn, torch.Generator().manual_seed(0))
    attn = attn.to(cuda_device).eval()
    x = torch.randn(2, 16, 32, 32, device=cuda_device).contiguous(memory_format=torch.channels_last)
    before = k6.LAUNCHES["fused_axial_attention"]
    with torch.no_grad():
        got = attn(x)
        attn.use_kernels = False
        ref = attn(x)
    assert k6.LAUNCHES["fused_axial_attention"] - before == 1
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 16)  # pooled 2x2
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-2


# K7: every output read as its error beyond its own rounding (2^-8 |ref| for
# the bf16 outputs sv, sve, d_q, d_k, d_qg, d_kg, d_v; none for the float32
# mu, var, d_relative, d_gamma) as a share of the output's rms, against the
# plain version in float32 on the same bf16 operands (chip_smoke.py's
# k7_readings, with the same limit).
K7_SHARE = 1e-3
K7_OUTPUTS = ("sv", "sve", "mu", "var", "d_q", "d_k", "d_qg", "d_kg", "d_v", "d_q_emb",
              "d_k_emb", "d_v_emb", "d_gamma")


def _k7_operands(device, n, length, g, gp, ks, seed=0):
    """bf16 operands with nonzero term means (so var's -mu^2 shows), f32
    ``relative`` and gamma, and bf16 upstream gradients of sv and sve."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    c = gp // 2
    bf = lambda t: t.to(torch.bfloat16)
    q, k = bf(r(n, length, g, c) + 0.5), bf(r(n, length, g, c) + 0.5)
    ops = [q, k, bf(q.float() * 0.3), bf(k.float() * 0.7), bf(r(n, length, g, gp)),
           r(2 * gp, 2 * ks - 1) / gp ** 0.5, 1.0 + 0.2 * r(3, g)]
    return ops, [bf(r(n, length, g, gp)), bf(r(n, length, g, gp))]


def _k7_run(fn, ops, cts, ks):
    """Outputs and the gradients of the seven operands, by name."""
    leaves = [t.detach().requires_grad_() for t in ops]
    sv, sve, mu, var = fn(*leaves, ks)
    grads = torch.autograd.grad((sv, sve), leaves, [c.to(sv.dtype) for c in cts])
    gp = ops[4].shape[-1]
    d_rel = grads[5]
    return dict(zip(K7_OUTPUTS, (sv, sve, mu, var, *grads[:5], d_rel[:gp // 2],
                                 d_rel[gp // 2:gp], d_rel[gp:], grads[6])))


def _k7_readings(got, ref, names=K7_OUTPUTS):
    out = {}
    for name in names:
        g, r = got[name].float(), ref[name].float()
        rounding = 2.0 ** -8 * r.abs() if got[name].dtype == torch.bfloat16 else 0.0
        out[name] = (((g - r).abs() - rounding).max() / r.pow(2).mean().sqrt()).item()
    return out


def _k7_reference(ops, cts, ks):
    return _k7_run(k7.fused_axial_train_reference, [t.float() for t in ops],
                   [c.float() for c in cts], ks)


@pytest.mark.cuda
@pytest.mark.parametrize("n,length,gp,ks", [
    (256, 128, 2, 128),    # gated layer1 at B=2 (L = 128, gp 2)
    (256, 128, 4, 128),    # layer2_0
    (128, 64, 8, 64),      # layer3_0
    (64, 32, 16, 32),      # layer4_0
    (37, 29, 4, 40),       # L = 29 < ks = 40: the ks - 1 offset, a ragged warp
    (16, 128, 32, 128),    # gp 32, L 128: one group per block, the most sums over i per lane
])
def test_fused_axial_train_kernel_matches_reference(cuda_device, monkeypatch, n, length, gp, ks):
    """K7's five grids against the plain version, forward and backward,
    and planted faults the same readings must reject: the combine without
    the e x̂ term (e zeroed after fin), var without -mu^2 (a, rsqrt(var + eps)
    and -mu rsqrt(var + eps) re-formed from E[x^2] after stats), d_relative
    from one bwd block per group (the others' partials zeroed after bwd), kr
    reading the k embedding untransposed (through the operands)."""
    ops, cts = _k7_operands(cuda_device, n, length, 8, gp, ks)
    ref = _k7_reference(ops, cts, ks)
    before = dict(k7.LAUNCHES)
    got = _k7_run(k7.fused_axial_train, ops, cts, ks)
    torch.cuda.synchronize()
    assert {k: k7.LAUNCHES[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    readings = _k7_readings(got, ref)
    assert max(readings.values()) <= K7_SHARE, readings
    caught = {name: _k7_readings(_k7_run(k7.fused_axial_train, fops, cts, ks), ref)
              for name, fops in _k7_faults(monkeypatch, ops)}
    for name, r in caught.items():
        assert max(r.values()) > K7_SHARE, (name, r)


def _k7_faults(monkeypatch, ops):
    """(name, operands) of each planted fault, with the fault in place while
    the caller runs it (generator: the patch is undone before the next)."""
    gp = ops[4].shape[-1]

    def wrap(name, after):
        orig = getattr(k7, name)

        def patched(call):
            orig(call)
            after(call)
        monkeypatch.setattr(k7, name, patched)

    def no_e(call):
        call.view("e").zero_()

    def var_without_mu2(call):
        mu, var, gamma = (call.tensors[x] for x in ("mu", "var", "gamma"))
        var.add_(mu * mu)
        inv = torch.rsqrt(var + call.eps)
        call.view("consts").copy_(torch.cat([gamma * inv, inv, -mu * inv]).reshape(-1))

    def one_block(call):
        g = call.dims["groups"]
        call.view("drel_part").view(g, call.plan.bwd_blocks, -1)[:, 1:].zero_()

    for name, hook, after in (("no e x_hat", "_finish", no_e),
                              ("var without -mu^2", "_stats", var_without_mu2),
                              ("d_relative from one block", "_backward_pass", one_block)):
        wrap(hook, after)
        yield name, ops
        monkeypatch.undo()
    k_flat = ops[5].clone()
    k_flat[gp // 2:gp] = ops[5][gp // 2:gp].flip(-1)
    yield "kr untransposed", ops[:5] + [k_flat, ops[6]]


@pytest.mark.cuda
def test_fused_axial_train_on_two_streams(cuda_device):
    """K7 forwards in flight at once on two streams of one device. Each call
    is one group (32 stats blocks), so two calls' grids fit the card side by
    side; both streams wait on one event recorded after a 20 ms spin, so the
    host has queued every call when the two streams start together and
    their blocks finish interleaved. Every call has operands of its own (a
    workspace the allocator hands on keeps the last call's partials). The
    stats grid elects its last block by its stream's own counter, so every
    call's mu and var (and sv, sve) match the plain version and both
    counters are back at 0 afterwards."""
    rounds = [[_k7_operands(cuda_device, 256, 128, 1, 4, 128, seed=2 * r + s)[0] for s in (0, 1)]
              for r in range(8)]
    streams = [torch.cuda.Stream(cuda_device) for _ in rounds[0]]
    for ops, stream in zip(rounds[0], streams):    # plan, build and counters before the spin
        with torch.cuda.stream(stream):
            k7.fused_axial_train(*ops, 128)
    torch.cuda.synchronize()
    start = torch.cuda.Event()
    with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
        torch.cuda._sleep(40_000_000)
        start.record()
    for stream in streams:
        stream.wait_event(start)
    outs = []
    for cases in rounds:
        for ops, stream in zip(cases, streams):
            with torch.cuda.stream(stream):
                outs.append(dict(zip(K7_OUTPUTS, k7.fused_axial_train(*ops, 128))))
    torch.cuda.synchronize()
    for ops, got in zip((ops for cases in rounds for ops in cases), outs):
        ref = k7.fused_axial_train_reference(*[t.float() for t in ops], 128)
        readings = _k7_readings(got, dict(zip(K7_OUTPUTS, ref)), K7_OUTPUTS[:4])
        assert max(readings.values()) <= K7_SHARE, readings
    for stream in streams:
        assert k7._TICKETS[rounds[0][0][0].device, stream.cuda_stream].item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("gp", k7.GROUP_PLANES)
@pytest.mark.parametrize("length", [5, 29, 32, 64, 128])
def test_axial_train_plan_matches_the_source(cuda_device, gp, length):
    """The shared memory axial_train.py plans for each grid is what the
    source carves (axial_train_smem), for every gp at every length class."""
    lib = k7._lib()
    p = k7.plan(64, length, 8, gp, max(length, 40))
    assert lib.axial_train_smem(0, gp, length, p.units) == k7.fwd_smem(0, gp, length, p.units)
    assert lib.axial_train_smem(1, gp, length, p.units) == k7.fwd_smem(1, gp, length, p.units)
    assert lib.axial_train_smem(2, gp, length, p.warps) == k7.bwd_smem(gp, length, p.warps)


@pytest.mark.cuda
def test_axial_attention_train_outside_kernel_shapes_raises(cuda_device):
    """No shape gate in training either: a bf16 block K7 does not take (gp 6;
    an axis of 256) raises and launches nothing, and so does a float32 block
    with use_kernels=True (K7 trains bf16 only); use_kernels=False trains it."""
    for gp, length, dtype, use_kernels in ((6, 32, torch.bfloat16, None),
                                           (4, 256, torch.bfloat16, None),
                                           (4, 32, torch.float32, True)):
        attn = AxialAttention(8 * gp, 8 * gp, 8, length, width_axis=True, mode="gated",
                              dtype=dtype, use_kernels=use_kernels)
        init_weights(attn, torch.Generator().manual_seed(0))
        attn = attn.to(cuda_device).train()
        x = torch.randn(2, 8 * gp, 2, length, device=cuda_device).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        before = dict(k7.LAUNCHES)
        with pytest.raises(ValueError, match="use_kernels=False"):
            attn(x)
        assert k7.LAUNCHES == before
        attn.use_kernels = False
        attn(x).float().sum().backward()
        assert torch.isfinite(attn.relative.grad).all()


# The whole bf16 gated step (64px, B=2) from seeded weights on GATED_STEP_BATCHES
# seeded batches (probes/gated_step.py): the median of the kernel path's
# relative loss difference to the same step with K7's plain version swapped
# in, and to the module path. At random weights one batch turns rounding into
# loss by a few percent, so the bar reads a median. The limit is the spread
# of two bf16 paths without K7 (K7's plain version against the module path,
# median 0.0397 on these batches); this design reads 0.0181 and 0.0334, the
# four-grid design before it 0.0357 and 0.0308 (PERF.md).
GATED_STEP_BATCHES = 8
GATED_STEP_LOSS = 4e-2


@pytest.mark.cuda
def test_gated_train_step_runs_k7_on_both_passes(cuda_device, monkeypatch):
    """One train step of bf16 gated (64px, B=2) on the kernel path and on the
    module path from the same weights and batch: every grid of K7 on all 16
    axis passes of the kernel path and none on the module path, finite loss
    and gradients on both, and every K7 launch of the kernel path's step,
    forward and backward, held against the plain version on the model's own
    operands and incoming gradients (K7_SHARE). Then the whole step's loss
    over GATED_STEP_BATCHES batches: the kernel path's median relative
    difference to the step with K7's plain version on the card, and to the
    module path, at most GATED_STEP_LOSS."""
    from unet_zoo_tpu_torch.probes import gated_step
    from unet_zoo_tpu_torch.train import create_train_state, make_train_step

    kernel, readings = k7.fused_axial_train, []

    class Checked(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, qg, kg, v, relative, gamma, ks, eps):
            leaves = [t.detach().requires_grad_() for t in (q, k, qg, kg, v, relative, gamma)]
            with torch.enable_grad():
                outs = kernel(*leaves, ks, eps)
            ctx.leaves, ctx.outs, ctx.ks = leaves, outs, ks
            rets = tuple(o.detach() for o in outs)
            ctx.mark_non_differentiable(rets[2], rets[3])
            return rets

        @staticmethod
        def backward(ctx, d_sv, d_sve, _d_mu, _d_var):
            cts = [d_sv.contiguous(), d_sve.contiguous()]
            grads = torch.autograd.grad(ctx.outs[:2], ctx.leaves, cts)
            gp = ctx.leaves[4].shape[-1]
            got = dict(zip(K7_OUTPUTS, (*(o.detach() for o in ctx.outs), *grads[:5],
                                        grads[5][:gp // 2], grads[5][gp // 2:gp], grads[5][gp:],
                                        grads[6])))
            with torch.enable_grad():      # off inside a backward
                ref = _k7_reference([t.detach() for t in ctx.leaves], cts, ctx.ks)
            readings.append(_k7_readings(got, ref))
            return (*grads, None, None)

    gen = torch.Generator().manual_seed(4)
    images = torch.randint(0, 256, (2, 3, 64, 64), generator=gen, dtype=torch.uint8)
    masks = (torch.rand(2, 1, 64, 64, generator=gen) > 0.5).to(torch.uint8)
    for use_kernels in (None, False):
        model = create_model("gated", dtype=torch.bfloat16, image_size=64, use_kernels=use_kernels)
        state = create_train_state(model)
        before = dict(k7.LAUNCHES)
        with monkeypatch.context() as m:
            m.setattr(k7, "fused_axial_train", lambda *a: Checked.apply(*a))
            metrics = make_train_step(model)(state, images, masks)
        torch.cuda.synchronize()
        launched = {k: k7.LAUNCHES[k] - before[k] for k in before}
        assert launched == dict.fromkeys(before, 16 if use_kernels is None else 0)
        assert all(torch.isfinite(p.grad).all() for p in model.module.parameters())
        assert torch.isfinite(metrics["loss"])
    assert len(readings) == 16
    worst = {k: max(r[k] for r in readings) for k in K7_OUTPUTS}
    assert max(worst.values()) <= K7_SHARE, worst
    rows = gated_step.readings(GATED_STEP_BATCHES, cuda_device,
                               paths=("kernel", "k7_plain", "module"))
    median = gated_step.medians(rows)
    assert median["rel_k7_plain"] <= GATED_STEP_LOSS, (median, rows)
    assert median["rel_module"] <= GATED_STEP_LOSS, (median, rows)


# K2: the error beyond the output's bf16 rounding (2^-8 |ref|) as a share of
# the output's rms (_k6_reading; chip_smoke.py reads it alike, same limit).
K2_SHARE = 1e-3


def _k2_case(device, b_, nh, n, hd, nw, dtype=torch.bfloat16, offset=0):
    """q, k, v as views of one [B_, N, 3, nh, hd] projection (the model's
    layout; ``offset`` elements into its storage), with a zero q row and a
    zero k row; tau from U(0.005, 0.1), so some entries lie below the 0.01
    clip; a bias of a few units; a random 0 / -100 mask of nW windows (None
    for nW 1)."""
    gen = torch.Generator(device=device).manual_seed(b_ + nh + n + hd + nw)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    qkv = r(b_ * n * 3 * nh * hd + offset).to(dtype)[offset:].view(b_, n, 3, nh, hd)
    qkv[0, 1, 0, 0] = 0.0
    qkv[0, 2, 1, 0] = 0.0
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    tau = 0.005 + 0.095 * torch.rand(nh, n, n, generator=gen, device=device)
    mask = None
    if nw > 1:
        mask = torch.where(torch.rand(nw, n, n, generator=gen, device=device) < 0.3, -100.0, 0.0)
    return q, k, v, tau, 3.0 * r(nh, n, n), mask


def _k2_faults(monkeypatch, q, k, v, tau, bias, mask):
    """K2's plain version with one fault planted each: the mask read by
    image (b // nW) instead of by window, tau unclipped, the softmax over
    the queries, the bias table transposed."""
    plain = k2.swin_window_attention_reference
    out = {"bias transposed": plain(q, k, v, tau, bias.transpose(1, 2).contiguous(), mask)}
    if mask is not None:
        by_image = (torch.arange(q.shape[0], device=q.device) // mask.shape[0]) % mask.shape[0]
        out["mask by image"] = plain(q, k, v, tau, bias, mask[by_image])
    with monkeypatch.context() as m:
        m.setattr(k2, "_clip_tau", lambda t: t.float())
        out["tau unclipped"] = plain(q, k, v, tau, bias, mask)
    softmax = torch.softmax
    with monkeypatch.context() as m:
        m.setattr(torch, "softmax", lambda t, dim: softmax(t, dim=-2))
        out["softmax over queries"] = plain(q, k, v, tau, bias, mask)
    return out


def _k2_design_faults(q, k, v, tau, bias, mask):
    """The mma instance's own planted faults (the source's
    ``window_attention_fault``): a block's windows given one mask index
    (where there is a mask) and P rounded once to bf16."""
    names = [f for f in k2.FAULTS if mask is not None or f != "one mask a block"]
    return {f: k2.planted_fault(f, q, k, v, tau, bias, mask) for f in names}


# Every launch shape of the served swin_unet_v2 (224px/window 7, 256px/window
# 8, B=8), odd shapes of the mma instance, and the general instance's shapes:
# (B_, nh, N, hd, nW, dtype, storage offset, instance)
K2_CASES = [(b_, nh, n, 32, nw, torch.bfloat16, 0, "mma")
            for n in (49, 64) for b_, nh, nws in ((512, 3, (64, 1)), (128, 6, (16, 1)),
                                                  (32, 12, (4, 1)), (8, 24, (1,)))
            for nw in nws] + [
    (6, 5, 49, 16, 3, torch.bfloat16, 0, "mma"),       # B_ not a multiple of 8, hd 16
    (10, 4, 36, 32, 2, torch.bfloat16, 0, "mma"),      # window 6: N not a multiple of 16
    (4, 3, 25, 16, 1, torch.bfloat16, 0, "mma"),       # window 5, two warps of padding
    (12, 2, 16, 8, 4, torch.float32, 0, "general"),    # float32 activations
    (4, 2, 100, 24, 2, torch.bfloat16, 0, "general"),  # window 10: four keys per lane
    (8, 3, 49, 32, 4, torch.float32, 0, "general"),    # a served shape in float32
    (8, 3, 49, 32, 4, torch.bfloat16, 1, "general"),   # rows off 16 bytes
]


@pytest.mark.cuda
@pytest.mark.parametrize("b_,nh,n,hd,nw,dtype,offset,which", K2_CASES)
def test_swin_window_attention_kernel_matches_reference(cuda_device, monkeypatch, b_, nh, n, hd,
                                                        nw, dtype, offset, which):
    q, k, v, tau, bias, mask = _k2_case(cuda_device, b_, nh, n, hd, nw, dtype, offset)
    f32 = [q.float(), k.float(), v.float(), tau, bias, mask]
    ref = k2.swin_window_attention_reference(*f32)
    assert k2.instance(q, k, v) == which
    before = dict(k2.LAUNCHES)
    got = k2.swin_window_attention(q, k, v, tau, bias, mask)
    torch.cuda.synchronize()
    assert k2.LAUNCHES["swin_window_attention"] - before["swin_window_attention"] == 1
    key = f"swin_window_attention_{which}"
    assert k2.LAUNCHES[key] - before[key] == 1
    assert got.dtype == dtype and got.shape == (b_, nh, n, hd)
    assert got.transpose(1, 2).is_contiguous()              # token-major for the projection
    assert _k6_reading(got, ref) <= K2_SHARE
    assert torch.equal(got, k2.swin_window_attention(q, k, v, tau, bias, mask))
    for name, out in _k2_faults(monkeypatch, *f32).items():
        assert _k6_reading(out, ref) > K2_SHARE, name
    if which == "mma":
        for name, out in _k2_design_faults(q, k, v, tau, bias, mask).items():
            assert _k6_reading(out, ref) > K2_SHARE, name


@pytest.mark.cuda
@pytest.mark.parametrize("b_,nh,n,hd,nw", sorted({c[:5] for c in K2_CASES if c[7] == "mma"})
                         + [(64, 3, 49, 32, 64), (2, 24, 64, 32, 1), (5, 7, 49, 16, 5)])
def test_window_attention_plan_matches_source(cuda_device, b_, nh, n, hd, nw):
    """plan()'s numbers against the built source's (window_attention_geometry)
    at every windows a block it considers."""
    p = k2.plan(b_, nh, n, hd, nw)
    for wpb in range(1, k2.MAX_WINDOWS_PER_BLOCK + 1):
        want = k2.layout(b_, nh, hd, nw, wpb)
        got = k2.source_geometry(b_, nh, hd, nw, nw > 1, wpb)
        assert got == (want.grid, want.threads, want.smem, want.per_group, want.chunks), wpb
    assert p.smem * 3 <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("wpb", [1, 2, 3, 8])
def test_window_attention_any_windows_a_block(cuda_device, monkeypatch, wpb):
    """The mma instance launched at windows a block other than the plan's
    (the source's entry, as the probe's sweep launches it), ragged last
    blocks included, agrees with the plain version."""
    for b_, nh, n, hd, nw in ((40, 3, 49, 32, 4), (13, 2, 64, 32, 1)):
        q, k, v, tau, bias, mask = _k2_case(cuda_device, b_, nh, n, hd, nw)
        ref = k2.swin_window_attention_reference(q.float(), k.float(), v.float(), tau, bias, mask)
        dims = k2._check_kernel_args(q, k, v, tau, bias, mask)
        assert k2.instance(q, k, v) == "mma"
        got = k2._run("window_attention_mma", dims, q, k, v, tau, bias, mask, wpb)
        assert _k6_reading(got, ref) <= K2_SHARE


@pytest.mark.cuda
def test_swin_window_attention_outside_kernel_shapes_raises(cuda_device):
    """The wrapper raises for what K2 does not take (naming use_kernels=False)
    and launches nothing; so does a bf16 block whose window K2 does not take
    (17 x 17 = 289 tokens), which use_kernels=False serves."""
    q, k, v, tau, bias, _ = _k2_case(cuda_device, 2, 1, 16, 8, 1)
    bad = [(q.half(), k.half(), v.half(), tau, bias, None),            # float16
           (q, k, v, tau.half(), bias, None),                         # float16 tau
           (q, k, v, tau, bias, torch.zeros(3, 16, 16, device=cuda_device)),   # nW does not divide B_
           (q, k, v, tau[:, :8], bias, None)]                         # tau's shape
    before = k2.LAUNCHES["swin_window_attention"]
    for args in bad:
        with pytest.raises(ValueError, match="use_kernels=False"):
            k2.swin_window_attention(*args)
    blk = SwinBlockV2(16, (17, 17), 2, window_size=17, dtype=torch.bfloat16)
    init_weights(blk, torch.Generator().manual_seed(0))
    blk = blk.to(cuda_device).eval()
    x = torch.randn(1, 17 * 17, 16, device=cuda_device).to(torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="use_kernels=False"):
        blk(x)
    assert k2.LAUNCHES["swin_window_attention"] == before
    blk.attn.use_kernels = False
    with torch.no_grad():
        assert torch.isfinite(blk(x).float()).all()


@pytest.mark.cuda
def test_window_attention_float32_runs_kernel(cuda_device):
    """use_kernels=True on a float32 module runs K2 in float32 and matches
    the module path."""
    attn = WindowAttentionV2(32, (4, 4), 4, use_kernels=True)
    init_weights(attn, torch.Generator().manual_seed(0))
    attn = attn.to(cuda_device).eval()
    x = torch.randn(8, 16, 32, device=cuda_device)
    mask = torch.where(torch.rand(4, 16, 16, device=cuda_device) < 0.3, -100.0, 0.0)
    before = k2.LAUNCHES["swin_window_attention"]
    with torch.no_grad():
        got = attn(x, mask)
        attn.use_kernels = False
        ref = attn(x, mask)
    assert k2.LAUNCHES["swin_window_attention"] - before == 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("image,window", [(224, 7), (256, 8)])
def test_swin_unet_v2_kernel_path_matches_plain_path(cuda_device, image, window):
    """bf16 swin_unet_v2 (embed 48, B=2) served on both paths: K2 on all 14
    window attentions (8 encoder, 6 decoder blocks); finite logits within
    chip_smoke.py's limit (3e-2 rel L2) of the plain path."""
    x = torch.randn(2, 3, image, image, generator=torch.Generator().manual_seed(2))
    x = x.to(cuda_device)
    preds = [make_predictor(create_model("swin_unet_v2", dtype=torch.bfloat16, image_size=image,
                                         window_size=window, embed_dim=48, use_kernels=k),
                            None, "logits") for k in (None, False)]
    before = dict(k2.LAUNCHES)
    got = preds[0](x).float()
    for key in ("swin_window_attention", "swin_window_attention_mma"):     # hd 16
        assert k2.LAUNCHES[key] - before[key] == 14
    ref = preds[1](x).float()
    assert got.shape == (2, 1, image, image) and torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= 3e-2


# K3 and K8 against their plain versions on the same bf16 operands, both
# rounded to bf16 once: the error beyond one bf16 ulp (2^-7 |ref|) as a share
# of the output's rms (chip_smoke.py's ulp_reading, the same limit).
K3_SHARE = K8_SHARE = 1e-3


def _ulp_reading(got, ref):
    excess = (got.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
    return (excess.max() / ref.float().pow(2).mean().sqrt()).item()


# K3's cases: the six served launch shapes of unext / unext_s (B=8, 256px),
# the further ones of missformer (512px and 256px) and unext_moe (B=8: the
# bridge's 16x16 and 8x8 tokens take bands of 2 and 1 rows, 512px's first
# stage bands of 64) and odd shapes on the stream instance; float32, k 5 and
# 7, C 20 and a misaligned x on the general one: (B, H, W, C, k, dtype,
# storage offset, instance)
K3_CASES = [(8, hw, hw, c, 3, torch.bfloat16, 0, "stream")
            for hw, c in ((64, 512), (32, 640), (16, 1024), (64, 256), (32, 512), (16, 640),
                          (128, 256), (32, 1280), (32, 256), (16, 2048), (16, 256), (16, 1280),
                          (8, 2048), (8, 256))] + [
    (2, 13, 21, 24, 3, torch.bfloat16, 0, "stream"),    # odd H, W
    (1, 5, 6, 520, 3, torch.bfloat16, 0, "stream"),     # C 520: a partial last chunk
    (3, 9, 7, 8, 3, torch.bfloat16, 0, "stream"),       # C 8
    (1, 70, 3, 40, 3, torch.bfloat16, 0, "stream"),     # tall, narrow
    (2, 13, 21, 20, 5, torch.bfloat16, 0, "general"),   # odd H, W; C not a multiple of 8; k 5
    (1, 15, 15, 6, 7, torch.bfloat16, 0, "general"),    # k 7
    (1, 9, 7, 37, 3, torch.float32, 0, "general"),      # odd C, float32
    (2, 11, 9, 16, 5, torch.float32, 0, "general"),     # float32, k 5
    (1, 12, 10, 24, 7, torch.float32, 0, "general"),    # float32, k 7
    (2, 10, 12, 20, 3, torch.bfloat16, 0, "general"),   # C 20 at k 3
    (2, 10, 12, 16, 3, torch.bfloat16, 4, "general"),   # x 8 bytes off 16
]


def _k3_case(device, b, h, w, c, k, dtype, offset=0, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed + b + h + c + k)
    r = lambda *s: torch.randn(*s, generator=gen, device=device).to(dtype)
    n = b * h * w * c
    x = torch.empty(n + offset, device=device, dtype=dtype)[offset:].view(b, h, w, c)
    x.copy_(r(b, h, w, c))
    return x, r(k, k, c) / k, r(c)


def _k3_faults(x, kern, bias):
    """K3's plain version with a fault planted each: the taps transposed,
    the bias dropped."""
    return {"taps transposed": k3.depthwise_conv2d_reference(
                x, kern.transpose(0, 1).contiguous(), bias),
            "bias dropped": k3.depthwise_conv2d_reference(x, kern)}


def _k3_design_faults(x, kern, bias):
    """The stream instance's own planted faults (the source's
    ``depthwise_stream_fault``), on plan()'s layout with bands of at most
    half the image, so that a band has a neighbour."""
    b, h, w, c = x.shape
    p = k3.plan(b, h, w, c)
    if p.bands == 1:
        p = k3.layout(b, h, w, c, p.lcv, max(1, h // 2), p.ring)
    return {f: k3.planted_fault(f, x, kern, bias, p) for f in k3.FAULTS}


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,k,dtype,offset,which", K3_CASES)
def test_depthwise_kernel_matches_reference(cuda_device, b, h, w, c, k, dtype, offset, which):
    x, kern, bias = _k3_case(cuda_device, b, h, w, c, k, dtype, offset)
    ref = k3.depthwise_conv2d_reference(x, kern, bias)
    assert k3.instance(x, kern) == which
    before = dict(k3.LAUNCHES)
    got = k3.depthwise_conv2d(x, kern, bias)
    torch.cuda.synchronize()
    assert k3.LAUNCHES["depthwise_conv2d"] - before["depthwise_conv2d"] == 1
    key = f"depthwise_conv2d_{which}"
    assert k3.LAUNCHES[key] - before[key] == 1
    assert got.dtype == dtype and got.shape == x.shape
    assert _ulp_reading(got, ref) <= K3_SHARE
    assert torch.equal(got, k3.depthwise_conv2d(x, kern, bias))
    assert _ulp_reading(k3.depthwise_conv2d(x, kern), k3.depthwise_conv2d_reference(x, kern)
                        ) <= K3_SHARE
    for name, fault in _k3_faults(x, kern, bias).items():
        assert _ulp_reading(got, fault) > K3_SHARE, name
    if which == "stream":
        for name, fault in _k3_design_faults(x, kern, bias).items():
            assert _ulp_reading(fault, ref) > K3_SHARE, name


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", sorted({c[:4] for c in K3_CASES if c[7] == "stream"})
                         + [(1, 16, 16, 640), (1, 64, 64, 256), (4, 32, 32, 512)])
def test_depthwise_plan_matches_source(cuda_device, b, h, w, c):
    """plan()'s numbers against the built source's (depthwise_geometry) at
    every chunk width, ring and a few band heights, and the blocks an SM the
    plan counts on against the CUDA runtime's occupancy of the instance."""
    p = k3.plan(b, h, w, c)
    for lcv in k3.LCVS:
        for ring in k3.RINGS:
            for bh in sorted({1, max(1, h // 3), p.bh, h}):
                want = k3.layout(b, h, w, c, lcv, bh, ring)
                got = k3.source_geometry(b, h, w, c, lcv, bh, ring, want.per_chunk)
                assert got == (want.grid, want.threads, want.smem, want.strips, want.bands,
                               want.chunks, want.items), (lcv, ring, bh)
    assert k3.source_occupancy(p.ring, p.smem) >= k3.BLOCKS_PER_SM


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,lcv,bh,ring,per_chunk", [
    (2, 12, 40, 32, 2, 5, 3, 3),         # several items a block, a partial last band
    (2, 11, 17, 64, 3, 4, 4, 2),         # partial strip, ring 4
    (1, 10, 9, 136, 4, 3, 6, 1),         # chunks of 16 vectors, C past the last chunk
    (3, 7, 33, 16, 2, 2, 6, 5),          # two-row bands
    (8, 64, 64, 512, 2, 8, 6, 16),       # a served shape streamed as a persistent grid
    (8, 16, 16, 1024, 3, 16, 3, 8),      # whole-image bands
])
def test_depthwise_stream_any_layout(cuda_device, b, h, w, c, lcv, bh, ring, per_chunk):
    """The stream instance laid out otherwise than by plan() (the source's
    entry, as the probe's sweep launches it) agrees with the plain version,
    twice bit for bit."""
    x, kern, bias = _k3_case(cuda_device, b, h, w, c, 3, torch.bfloat16)
    p = k3.layout(b, h, w, c, lcv, bh, ring, per_chunk)
    got = k3.run_stream(x, kern, bias, p)
    torch.cuda.synchronize()
    assert _ulp_reading(got, k3.depthwise_conv2d_reference(x, kern, bias)) <= K3_SHARE
    assert torch.equal(got, k3.run_stream(x, kern, bias, p))


@pytest.mark.cuda
def test_depthwise_outside_kernel_shapes_raises(cuda_device):
    x = torch.zeros(1, 8, 8, 16, device=cuda_device, dtype=torch.bfloat16)
    kern = torch.zeros(3, 3, 16, device=cuda_device, dtype=torch.bfloat16)
    before = k3.LAUNCHES["depthwise_conv2d"]
    for args in ((x.half(), kern.half(), None),                               # float16
                 (x, torch.zeros(9, 9, 16, device=cuda_device, dtype=torch.bfloat16), None),
                 (x, kern.float(), None),                                     # mixed types
                 (x.transpose(1, 2), kern, None)):                            # not contiguous
        with pytest.raises(ValueError, match="use_kernels=False"):
            k3.depthwise_conv2d(*args)
    assert k3.LAUNCHES["depthwise_conv2d"] == before


@pytest.mark.cuda
def test_depthwise_refused_stream_launch_raises(cuda_device, monkeypatch):
    """A stream launch that the source refuses (a ring it has no instance
    for) raises, from the wrapper and from a served unext_s forward; nothing
    runs the general instance or the plain version instead."""
    x, kern, bias = _k3_case(cuda_device, 2, 16, 16, 64, 3, torch.bfloat16)
    ints = list(k3._served_ints(2, 16, 16, 64))
    ints[6] = 5                                   # ring 5: no such instance
    monkeypatch.setattr(k3, "_served_ints", lambda *shape: (*shape, *ints[4:]))
    before = dict(k3.LAUNCHES)
    with pytest.raises(RuntimeError, match="depthwise_stream launch failed"):
        k3.depthwise_conv2d(x, kern, bias)
    pred = make_predictor(create_model("unext_s", dtype=torch.bfloat16), None, "logits")
    with pytest.raises(RuntimeError, match="depthwise_stream launch failed"):
        pred(torch.randn(1, 3, 64, 64, device=cuda_device))
    assert k3.LAUNCHES == before


# unext / wranet / missformer, kernel path vs plain path (bf16 logits,
# relative L2), the limits chip_smoke.py holds the full-width forwards to
UNEXT_REL_L2, WRANET_REL_L2, MISSFORMER_REL_L2 = 1e-2, 3e-2, 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name,launches", [("unext_s", 6), ("unext", 13), ("unext_moe", 3)])
def test_unext_kernel_path_matches_plain_path(cuda_device, name, launches):
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    preds = [make_predictor(create_model(name, dtype=torch.bfloat16, use_kernels=k), None,
                            "logits") for k in (None, False)]
    before = dict(k3.LAUNCHES)
    got = preds[0](x).float()
    for key in ("depthwise_conv2d", "depthwise_conv2d_stream"):
        assert k3.LAUNCHES[key] - before[key] == launches
    ref = preds[1](x).float()
    assert got.shape == (2, 1, 64, 64) and torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= UNEXT_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 32])
def test_missformer_kernel_path_matches_plain_path(cuda_device, size):
    """missformer (bf16, B=2): K3 on all 32 MixFFN_skip convs on its stream
    instance, every launch within K3's bar of its plain version on its own
    operands, and the logits against the plain path's (at 32px the stages
    are 8, 4, 2 and 1 pixels)."""
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    preds = [make_predictor(create_model("missformer", dtype=torch.bfloat16, image_size=size,
                                         use_kernels=k), None, "logits") for k in (None, False)]
    real, readings = k3.depthwise_conv2d, []

    def checked(*a):
        got = real(*a)
        readings.append(_ulp_reading(got, k3.depthwise_conv2d_reference(*a)))
        return got

    before = dict(k3.LAUNCHES)
    k3.depthwise_conv2d = checked
    try:
        got = preds[0](x).float()
    finally:
        k3.depthwise_conv2d = real
    for key in ("depthwise_conv2d", "depthwise_conv2d_stream"):
        assert k3.LAUNCHES[key] - before[key] == 32
    assert len(readings) == 32 and max(readings) <= K3_SHARE
    ref = preds[1](x).float()
    assert got.shape == (2, 1, size, size) and torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= MISSFORMER_REL_L2


def _deform_case(device, b, h, w, c, o, scale=3.0, seed=0, k=3, stride=1, pad=1, dil=1):
    """bf16 operands: offsets of std ``scale`` pixels (at 3 and 8, samples
    past every edge), sigmoid masks, a k x k weight of O(1) outputs."""
    gen = torch.Generator(device=device).manual_seed(seed + b + h + c + o)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    bf = torch.bfloat16
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    return (r(b, h, w, c).to(bf), (scale * r(b, ho, wo, 2 * k * k)).to(bf),
            torch.sigmoid(2 * r(b, ho, wo, k * k)).to(bf),
            (r(k, k, c, o) / (k * k * c) ** 0.5).to(bf), r(o).to(bf))


# (B, H, W, C, O, k, stride, padding, dilation)
DEFORM_SHAPES = [
    (8, 128, 128, 128, 32, 3, 1, 1, 1),    # wranet's decoder_lv2 at 256px (B=8)
    (8, 256, 256, 128, 32, 3, 1, 1, 1),    # wranet's decoder_lv1
    (2, 37, 45, 40, 24, 3, 1, 1, 1),       # odd H, W; C 40, O 24
    (2, 17, 13, 40, 24, 3, 1, 1, 1),       # odd H, W; fewer rows than a block tile
    (1, 9, 11, 20, 5, 3, 1, 1, 1),         # C not a multiple of 8, odd O
    (2, 20, 23, 64, 128, 3, 1, 1, 1),      # O 128: the 128-column accumulator
    (1, 6, 7, 128, 100, 3, 1, 1, 1),       # O 100, fewer output columns than a tile
    (1, 19, 21, 24, 16, 7, 1, 3, 1),       # 7x7 kernel: K 49
    (2, 33, 31, 48, 32, 3, 2, 1, 1),       # stride 2
    (2, 29, 27, 32, 32, 3, 1, 2, 2),       # dilation 2
    (1, 12, 10, 200, 40, 3, 1, 1, 1),      # C 200: two channel chunks
    (1, 9, 9, 264, 128, 7, 1, 3, 1),       # W streamed: K 49 x 3 chunks x O 128
]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.0, 1.0, 3.0, 8.0])
@pytest.mark.parametrize("b,h,w,c,o,k,stride,pad,dil", DEFORM_SHAPES)
def test_deform_kernel_matches_reference(cuda_device, b, h, w, c, o, k, stride, pad, dil, scale):
    """K8 against its plain version, offsets of std 0, 1, 3 and 8 pixels;
    two launches bit for bit; planted faults (the mask ignored, the bias
    dropped, each tap's row tile multiplied by the next tap's weights) fail
    the same check."""
    x, off, m, wt, bias = _deform_case(cuda_device, b, h, w, c, o, scale, k=k, stride=stride,
                                       pad=pad, dil=dil)
    conv = dict(stride=stride, padding=pad, dilation=dil)
    ref = k8.deform_conv2d_reference(x, off, m, wt, bias, **conv)
    before = k8.LAUNCHES["deform_conv2d"]
    got = k8.deform_conv2d(x, off, m, wt, bias, **conv)
    again = k8.deform_conv2d(x, off, m, wt, bias, **conv)
    torch.cuda.synchronize()
    assert k8.LAUNCHES["deform_conv2d"] - before == 2
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.equal(got, again)
    assert _ulp_reading(got, ref) <= K8_SHARE
    for fault in (k8.deform_conv2d_reference(x, off, torch.ones_like(m), wt, bias, **conv),
                  k8.deform_conv2d_reference(x, off, m, wt, **conv),
                  k8.planted_fault(x, off, m, wt, bias, **conv)):
        assert _ulp_reading(got, fault) > K8_SHARE
    assert k8.LAUNCHES["deform_conv2d"] - before == 2


# (B, H, W, C, O) with a 3x3 kernel whose plans take each patch and block
# layout and W in tap groups, and the layout: (patch, block, tap group)
DEFORM_LAYOUTS = [
    ((2, 128, 128, 128, 32), ((4, 4), (4, 4), 9)),     # wranet's: W resident
    ((2, 40, 1, 32, 32), ((16, 1), (16, 1), 9)),       # one output column
    ((2, 40, 2, 32, 32), ((8, 2), (16, 1), 9)),        # two
    ((2, 40, 5, 32, 32), ((4, 4), (8, 2), 9)),         # five: two patches across
    ((2, 40, 45, 64, 100), ((4, 4), (2, 4), 9)),       # 8 warps
    ((2, 48, 48, 200, 40), ((4, 4), (4, 4), 4)),       # two chunks: W in groups of 4 taps
    ((1, 24, 24, 512, 128), ((4, 4), (2, 4), 1)),      # four chunks: W one tap at a time
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", DEFORM_LAYOUTS)
def test_deform_plans_match_reference(cuda_device, shape, layout):
    """Each patch and block layout that plan() picks, W resident and in tap
    groups, at offsets of std 3 agrees with the plain version, and the
    planted fault fails under each."""
    b, h, w, c, o = shape
    p = k8.plan(b, c, o, 9, h, w)
    assert ((p.th, p.tw), (p.wy, p.wx), p.group) == layout
    x, off, m, wt, bias = _deform_case(cuda_device, b, h, w, c, o)
    ref = k8.deform_conv2d_reference(x, off, m, wt, bias)
    got = k8.deform_conv2d(x, off, m, wt, bias)
    fault = k8.planted_fault(x, off, m, wt, bias)
    torch.cuda.synchronize()
    assert _ulp_reading(got, ref) <= K8_SHARE
    assert _ulp_reading(fault, ref) > K8_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,o,k,stride,pad,dil", DEFORM_SHAPES)
def test_deform_plan_matches_source(cuda_device, b, h, w, c, o, k, stride, pad, dil):
    """plan()'s tiles, warps and shared memory are the built source's own."""
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    p = k8.plan(b, c, o, k * k, ho, wo)
    assert k8.source_geometry(b, h, w, c, o, k, k, ho, wo, p) == (
        p.tiles, p.ck, p.nch, p.warps, 8 * p.nt + 8, p.smem)


@pytest.mark.cuda
def test_deform_outside_kernel_shapes_raises(cuda_device):
    """The wrapper raises for what K8 does not take (naming use_kernels=False)
    and launches nothing; a float32 DeformableConv with use_kernels=True
    raises, and use_kernels=False serves it."""
    x, off, m, wt, bias = _deform_case(cuda_device, 1, 8, 8, 16, 8)
    before = k8.LAUNCHES["deform_conv2d"]
    for args in ((x.float(), off, m, wt, bias),                      # float32 x
                 (x, off, m, torch.zeros(3, 3, 16, 200, device=cuda_device,
                                         dtype=torch.bfloat16), None),   # O above 128
                 (x, off[..., :16], m, wt, bias)):                   # offset's taps
        with pytest.raises(ValueError, match="use_kernels=False"):
            k8.deform_conv2d(*args)
    dc = DeformableConv(16, 8, use_bias=True, use_kernels=True).to(cuda_device).eval()
    xc = torch.randn(1, 16, 8, 8, device=cuda_device).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), pytest.raises(ValueError, match="use_kernels=False"):
        dc(xc)
    assert k8.LAUNCHES["deform_conv2d"] == before
    dc.use_kernels = False
    with torch.no_grad():
        assert torch.isfinite(dc(xc)).all()


@pytest.mark.cuda
def test_wranet_kernel_path_matches_plain_path(cuda_device):
    """bf16 wranet (registry width, B=2, 64px) with its offset and modulator
    convs drawn off zero on both paths: K8 twice per forward; logits within
    chip_smoke.py's limit of the plain path."""
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    preds = []
    for k in (None, False):
        model = create_model("wranet", dtype=torch.bfloat16, use_kernels=k)
        g = torch.Generator().manual_seed(12)
        with torch.no_grad():
            for mod in model.module.modules():
                if isinstance(mod, DeformableConv):
                    for conv_m, std in ((mod.offset_conv, 3.0), (mod.modulator_conv, 1.5)):
                        fan_in = conv_m.weight[0].numel()
                        conv_m.weight.copy_(std / fan_in ** 0.5 * torch.randn(
                            conv_m.weight.shape, generator=g))
        preds.append(make_predictor(model, None, "logits"))
    before = k8.LAUNCHES["deform_conv2d"]
    got = preds[0](x).float()
    assert k8.LAUNCHES["deform_conv2d"] - before == 2
    ref = preds[1](x).float()
    assert got.shape == (2, 1, 64, 64) and torch.isfinite(got).all()
    assert ((got - ref).norm() / ref.norm()).item() <= WRANET_REL_L2


# P2, the int8 conv: x is quantised inside the kernel by a true division and
# rounding half to even, the integer sums are exact and the epilogue rounds as
# the plain version does, so kernel and plain version agree bit for bit.
# s_x = 2^-3 puts a tenth of x on exact half-way points of x / s_x, and a
# twentieth beyond +-127 s_x, where it clamps.
def _int8_conv_case(device, b, h, w, ci, co, dtype, seed=0, bias=True):
    gen = torch.Generator(device=device).manual_seed(seed + b + h + ci + co)
    s_x = torch.tensor(0.125, device=device)
    x = torch.randn(b, h, w, ci, generator=gen, device=device) * 40 * s_x
    spots = torch.rand(b, h, w, ci, generator=gen, device=device)
    half = (torch.randint(-127, 127, (b, h, w, ci), generator=gen, device=device) + 0.5) * s_x
    x = torch.where(spots < 0.1, half, x)
    x = torch.where(spots > 0.95, torch.sign(x) * 200 * s_x, x).to(dtype)
    wq = torch.randint(-127, 128, (co, ci, 3, 3), generator=gen, device=device,
                       dtype=torch.int8)
    scale = torch.rand(co, generator=gen, device=device) * 1e-4
    bvec = torch.randn(co, generator=gen, device=device) if bias else None
    return x, s_x, p2.pack_conv_weight(wq), scale, bvec


def _ties_away(x, s_x):
    """x quantised with ties rounded away from zero (a planted fault)."""
    t = x.float() / s_x
    return torch.clamp(torch.trunc(t + 0.5 * torch.sign(t)), -127, 127)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,ci,co,stride,dtype", [
    (2, 64, 64, 128, 128, 1, torch.bfloat16),     # unet_tpu enc0 (B=2)
    (2, 64, 64, 128, 256, 2, torch.bfloat16),     # unet_tpu down0
    (2, 16, 16, 1024, 512, 1, torch.bfloat16),    # unet_tpu dec2, K = 9216, K split
    (8, 8, 8, 512, 512, 1, torch.bfloat16),       # unet_tpu bottleneck, K split 12 ways
    (2, 256, 256, 3, 64, 1, torch.float32),       # unet's first conv: Ci 3, K 27
    (2, 128, 128, 128, 64, 1, torch.float32),     # unet up_convolution_4 (Co 64 tile)
    (1, 17, 13, 20, 24, 1, torch.float32),        # odd H, W; Ci 20 (element loader); Co 24
    (1, 17, 15, 48, 40, 2, torch.bfloat16),       # stride 2 on an odd size
    (3, 9, 7, 32, 130, 2, torch.float32),         # ragged N tile, odd Ho/Wo
    (2, 32, 32, 16, 24, 1, torch.float32),        # halo, Ci 16: 8 taps a stage
    (2, 32, 32, 32, 40, 1, torch.bfloat16),       # halo, Ci 32: 4 taps a stage
    (2, 64, 64, 64, 64, 1, torch.float32),        # halo, Ci 64: 2 taps a stage
    (2, 32, 32, 1024, 512, 1, torch.bfloat16),    # attention_unet up5 and upconv5's first conv
    (2, 16, 16, 1024, 1024, 1, torch.bfloat16),   # attention_unet conv5's second conv
    (2, 256, 256, 128, 64, 1, torch.bfloat16),    # attention_unet upconv2's first conv
    (2, 256, 256, 3, 64, 1, torch.bfloat16),      # attention_unet conv1's first conv, bf16 out
])
def test_int8_conv_kernel_matches_reference(cuda_device, xdtype, b, h, w, ci, co, stride, dtype):
    x, s_x, wp, scale, bias = _int8_conv_case(cuda_device, b, h, w, ci, co, xdtype)
    before = p2.LAUNCHES["int8_conv3x3"]
    got = p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, dtype)
    torch.cuda.synchronize()
    assert p2.LAUNCHES["int8_conv3x3"] - before == 1
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, ho, wo, co)
    assert torch.equal(got, p2.int8_conv3x3_reference(x, s_x, wp, scale, bias, stride, dtype))
    assert torch.equal(p2.int8_conv3x3(x, s_x, wp, scale, None, stride, dtype),
                       p2.int8_conv3x3_reference(x, s_x, wp, scale, None, stride, dtype))
    one = torch.ones((), device=cuda_device)
    for fault in (p2.int8_conv3x3_reference(x, s_x, wp, scale, None, stride, dtype),
                  p2.int8_conv3x3_reference(x, s_x, wp, scale.flip(0), bias, stride, dtype),
                  p2.int8_conv3x3_reference(_ties_away(x, s_x), one, wp, scale, bias, stride,
                                            dtype)):
        assert not torch.equal(got, fault)


def _carrier_conv_shapes():
    """Each distinct int8 conv launch shape of the served transatt_unet and
    unet_transformer (256px), at B=8 (the served batch)."""
    from unet_zoo_tpu_torch.probes.int8_conv_plan import launch_shapes

    rows = []
    for name in ("transatt_unet", "unet_transformer"):
        rows += [row[:6] for row in launch_shapes(name, 256, 8) if row[:6] not in rows]
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co,stride", _carrier_conv_shapes())
def test_int8_conv_matches_reference_at_carrier_shapes(cuda_device, b, h, w, ci, co, stride):
    """P2 at every launch shape of int8 transatt_unet and unet_transformer
    (bf16 x and out, as served), one launch each, bit for bit with its plain
    version; a planted fault (the bias dropped) is told apart."""
    x, s_x, wp, scale, bias = _int8_conv_case(cuda_device, b, h, w, ci, co, torch.bfloat16)
    before = p2.LAUNCHES["int8_conv3x3"]
    got = p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, torch.bfloat16)
    torch.cuda.synchronize()
    assert p2.LAUNCHES["int8_conv3x3"] - before == 1
    want = p2.int8_conv3x3_reference(x, s_x, wp, scale, bias, stride, torch.bfloat16)
    assert got.shape == (b, h, w, co) and torch.equal(got, want)
    assert not torch.equal(got, p2.int8_conv3x3_reference(x, s_x, wp, scale, None, stride,
                                                          torch.bfloat16))


@pytest.mark.cuda
def test_int8_conv_splits_k_and_copies_strided_x(cuda_device):
    """A shape the plan splits: the counters are all 0 again after the
    launch, and a second launch agrees; an NCHW-contiguous x is copied once
    (X_COPIES) and gives the same result."""
    x, s_x, wp, scale, bias = _int8_conv_case(cuda_device, 8, 8, 8, 512, 512, torch.bfloat16)
    assert p2.conv_plan(8 * 8 * 8, 512, wp.shape[1])[2] > 1
    first = p2.int8_conv3x3(x, s_x, wp, scale, bias, 1, torch.bfloat16)
    torch.cuda.synchronize()
    assert not p2._COUNTERS[x.device, torch.cuda.current_stream().cuda_stream].any()
    copies = p2.X_COPIES["int8_conv3x3"]
    strided = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    assert torch.equal(p2.int8_conv3x3(strided, s_x, wp, scale, bias, 1, torch.bfloat16), first)
    assert p2.X_COPIES["int8_conv3x3"] == copies + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ci,co,stride", [
    (8, 8, 8, 512, 512, 1),       # unet_tpu bottleneck: 36 K stages
    (2, 32, 32, 64, 200, 1),      # halo producer, ragged N
    (1, 17, 15, 48, 40, 2),       # per-tap gather, stride 2
])
def test_int8_conv_every_plan_agrees(cuda_device, b, h, w, ci, co, stride):
    """Every block tile width, with K unsplit, split two ways and split
    into single stages, gives the plan's result bit for bit."""
    x, s_x, wp, scale, bias = _int8_conv_case(cuda_device, b, h, w, ci, co, torch.bfloat16)
    want = p2.int8_conv3x3_reference(x, s_x, wp, scale, bias, stride, torch.bfloat16)
    stages = -(-wp.shape[1] // p2.K_STAGE)
    for bn in p2.TILE_N:
        for splits in sorted({1, min(2, stages), stages}):
            got = p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, torch.bfloat16,
                                  plan=(p2.BM, bn, splits))
            assert torch.equal(got, want), (bn, splits)
    with pytest.raises(ValueError, match="use_kernels=False"):
        p2.int8_conv3x3(x, s_x, wp, scale, bias, stride, torch.bfloat16,
                        plan=(p2.BM, 96, 1))


@pytest.mark.cuda
def test_int8_conv_outside_kernel_shapes_raises(cuda_device):
    x, s_x, wp, scale, bias = _int8_conv_case(cuda_device, 1, 8, 8, 16, 8, torch.float32)
    before = p2.LAUNCHES["int8_conv3x3"]
    for args in ((x.half(), s_x, wp, scale, bias, 1, torch.float32),             # float16 x
                 (x.to(torch.int8), s_x, wp, scale, bias, 1, torch.float32),    # int8 x
                 (x, s_x.double(), wp, scale, bias, 1, torch.float32),
                 (x, s_x, wp, scale, bias, 3, torch.float32),                   # stride 3
                 (x, s_x, wp[:, :100].contiguous(), scale, bias, 1, torch.float32),  # unpacked
                 (x, s_x, wp, scale.double(), bias, 1, torch.float32),
                 (x, s_x, wp, scale, bias, 1, torch.float16)):
        with pytest.raises(ValueError, match="use_kernels=False"):
            p2.int8_conv3x3(*args)
    assert p2.LAUNCHES["int8_conv3x3"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("tile", p2.GEMM_TILES)
@pytest.mark.parametrize("m,n,k", [
    (512, 384, 1024),
    (300, 200, 64),       # ragged M and N, K one half-stage (s8)
    (300, 200, 128),
    (131, 1000, 4096),
    (1, 8, 4096),
])
def test_gemm_kernel_matches_reference(cuda_device, m, n, k, tile):
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + k)
    a8 = torch.randint(-127, 128, (m, k), generator=gen, device=cuda_device, dtype=torch.int8)
    b8 = torch.randint(-127, 128, (n, k), generator=gen, device=cuda_device, dtype=torch.int8)
    before = p2.LAUNCHES["matmul"]
    got = p2.matmul(a8, b8, tile)
    torch.cuda.synchronize()
    assert p2.LAUNCHES["matmul"] - before == 1
    assert got.dtype == torch.int32 and torch.equal(got, p2.matmul_reference(a8, b8))
    if m > 16 and n % 8 == 0:
        assert torch.equal(got, torch._int_mm(a8, b8.t()))
    a16 = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    b16 = torch.randn(n, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    got, ref = p2.matmul(a16, b16, tile), p2.matmul_reference(a16, b16)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= 1e-5 * k ** 0.5 * ref.pow(2).mean().sqrt().item()
    fault = p2.matmul_reference(a16, b16.roll(1, 0))
    assert (got - fault).abs().max().item() > 1e-5 * k ** 0.5 * ref.pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,n", [(4096, 128, 4096), (100, 20, 333), (7, 4, 1)])
def test_row_gather_kernel_matches_reference(cuda_device, rows, c, n):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + c)
    tab = torch.randn(rows, c, generator=gen, device=cuda_device)
    idx = torch.randint(0, rows, (n,), generator=gen, device=cuda_device, dtype=torch.int32)
    before = p1.LAUNCHES["row_gather"]
    got = p1.row_gather(tab, idx)
    torch.cuda.synchronize()
    assert p1.LAUNCHES["row_gather"] - before == 1
    assert torch.equal(got, p1.row_gather_reference(tab, idx))


@pytest.mark.cuda
def test_new_sources_build_without_spills(cuda_device):
    """ptxas's register and spill report for the P1 and P2 sources."""
    build.build_all()
    for stem in ("int8_gemm", "row_gather"):
        log = (build.BUILD_DIR / f"{stem}.log").read_text()
        assert "registers" in log
        assert all(" 0 bytes spill stores" in line for line in log.splitlines()
                   if "spill stores" in line), log


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,launches", [("unet_tpu", torch.bfloat16, 17),
                                                 ("unet", torch.float32, 18),
                                                 ("attention_unet", torch.bfloat16, 22),
                                                 ("nested_unet", torch.bfloat16, 30),
                                                 ("transatt_unet", torch.bfloat16, 18),
                                                 ("unet_transformer", torch.bfloat16, 14)])
def test_int8_serving_runs_the_kernel(cuda_device, name, dtype, launches):
    """Calibrated int8 serving (B=2, 64px): the int8 conv kernel on every
    gated conv, K1 not at all in the float32 unet; the kernel path's logits
    equal the plain path's bit for bit (same integer sums, same epilogue)."""
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    kw = {"widths": (32, 64, 64, 64)} if name == "unet_tpu" else {}
    preds = []
    for k in (None, False):
        model = create_model(name, dtype=dtype, use_kernels=k, **kw)
        stats = calibrate_int8(model, [x])
        preds.append(make_predictor(model, None, "logits", cast_bf16=dtype == torch.bfloat16,
                                    quant=stats))
    before = p2.LAUNCHES["int8_conv3x3"], k1.LAUNCHES["fused_up_concat_conv"]
    got = preds[0](x)
    torch.cuda.synchronize()
    assert p2.LAUNCHES["int8_conv3x3"] - before[0] == launches
    assert k1.LAUNCHES["fused_up_concat_conv"] == before[1]
    assert torch.isfinite(got).all() and torch.equal(got, preds[1](x))


@pytest.mark.cuda
def test_attention_unet_int8_launches_read_x_in_place(cuda_device, monkeypatch):
    """int8 attention_unet (bf16, B=2, 64px): each of the 22 P2 launches of a
    forward, the convs on nearest-upsampled and on concatenated activations
    among them, reads its x in place (no copy to channels-last) and equals
    the plain version on its own operands bit for bit; a 1x1 or dilated
    gated conv (resunet, u2net) makes the predictor raise instead."""
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(9)).to(cuda_device)
    model = create_model("attention_unet", dtype=torch.bfloat16)
    pred = make_predictor(model, None, "logits", quant=calibrate_int8(model, [x]))
    kernel, seen = p2.int8_conv3x3, []

    def launch(x_, *args):
        got = kernel(x_, *args)
        seen.append((x_.is_contiguous(), torch.equal(got, p2.int8_conv3x3_reference(x_, *args))))
        return got

    monkeypatch.setattr(p2, "int8_conv3x3", launch)
    copies = p2.X_COPIES["int8_conv3x3"]
    assert torch.isfinite(pred(x)).all()
    assert seen == [(True, True)] * 22 and p2.X_COPIES["int8_conv3x3"] == copies
    for name in ("resunet", "u2net"):
        other = create_model(name, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="the int8 conv takes 3x3 convs"):
            make_predictor(other, None, "logits", quant=calibrate_int8(other, [x]))
