"""The port's CUDA kernels (K1, K4, K5) against their plain PyTorch
versions, and each model's kernel path against its plain path, on the card.

These need an NVIDIA GPU (sm_90a) and ``nvcc``: a CUDA kernel has no CPU
mode, so every test here skips without a card. The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies::

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.mmunet import MKBlock
from unet_zoo_tpu_torch.nn import init_weights
from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
from unet_zoo_tpu_torch.ops.kernels import morph as k5
from unet_zoo_tpu_torch.utils.serving import make_predictor


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,hc,wc,cin,cu,cs,co", [
    (2, 8, 8, 128, 64, 64, 64),     # unet's last stage, narrow
    (1, 8, 12, 96, 64, 32, 48),     # non-square, Co != Cu
    (3, 5, 7, 64, 32, 32, 40),      # ragged M and N tiles
])
def test_fused_up_kernel_matches_reference(cuda_device, b, hc, wc, cin, cu, cs, co):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    args = _case(gen, cuda_device, b, hc, wc, cin, cu, cs, co)
    ref = k1.fused_up_concat_conv_reference(*[a.float() for a in args])
    got = k1.fused_up_concat_conv(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - ref).abs().max().item()
    assert err <= 1e-2 * (1 + ref.abs().max().item()), err


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


def _mkblock_weights(device, c):
    """A random MKBlock with BN and biases off identity, folded."""
    blk = MKBlock(c)
    init_weights(blk, torch.Generator().manual_seed(0))
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,h,w,k,repeat", [
    (2, 192, 64, 64, 7, 2),
    (1, 768, 16, 16, 7, 2),
    (2, 96, 40, 24, 7, 1),
    (1, 24, 13, 29, 7, 2),     # ragged tiles
    (3, 16, 9, 9, 7, 1),       # an image smaller than the halo
])
def test_fused_softmax_morph_kernel_matches_reference(cuda_device, b, c, h, w, k, repeat):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (2 * torch.randn(b, c, h, w, generator=gen, device=cuda_device)).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    d_ref, e_ref = k5.fused_softmax_morph_reference(x.float(), k, repeat)
    d, e = k5.fused_softmax_morph(x, k, repeat)
    torch.cuda.synchronize()
    for got, ref in ((d, d_ref), (e, e_ref)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
        assert _k5_reading(got, ref) <= K5_REL
    # an erosion of zeros, or one of the wrong window, fails the same comparison
    assert _k5_reading(torch.zeros_like(e), e_ref) > K5_REL
    assert _k5_reading(k5.fused_softmax_morph_reference(x.float(), 5, repeat)[1], e_ref) > K5_REL


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
