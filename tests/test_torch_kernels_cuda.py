"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU (sm_90a) and ``nvcc``: a CUDA kernel has no CPU
mode, so every test here skips without a card. The file imports nothing of
JAX, so it runs on a machine that has only the port's dependencies::

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import pytest
import torch

from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
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
