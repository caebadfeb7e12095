"""K1, the fused decoder stage, in the port against the JAX package.

On the CPU the port's wrapper runs its plain version, which is held here
against the JAX Pallas kernel in interpret mode (the JAX tests' own way of
running it off-TPU). The CUDA kernel itself is held against the plain
version by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.nn.blocks import UpSampleUNet as JaxUpSampleUNet
from unet_zoo_tpu.ops.pallas import fused_up as jax_fused
from unet_zoo_tpu_torch.nn import UpSampleUNet
from unet_zoo_tpu_torch.ops.kernels import fused_up as k1

torch.set_num_threads(1)

CL = torch.channels_last


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _convt_to_torch(k):
    """Flax ConvTranspose kernel [2,2,Cin,Cu] -> torch weight [Cin,Cu,2,2]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1)))


def _conv_to_torch(k):
    """Flax Conv kernel HWIO -> torch OIHW."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def _rand_case(rng, B, Hc, Wc, Cin, Cu, Cs, Co):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(B, Hc, Wc, Cin), f(B, 2 * Hc, 2 * Wc, Cs), f(2, 2, Cin, Cu) * 0.1,
            f(Cu) * 0.1, f(3, 3, Cu + Cs, Co) * 0.05, f(Co) * 0.2 + 1.0, f(Co) * 0.1)


def _port_args(y, skip, wt, bt, wc, scale, bias):
    t = torch.from_numpy
    return (_nchw(y), _nchw(skip), k1.pack_convt_kernel(_convt_to_torch(wt)), t(bt),
            k1.pack_conv3x3_kernel(_conv_to_torch(wc)), t(scale), t(bias))


# the parameter sets of tests/test_fused_up.py::test_fused_matches_xla_chain
@pytest.mark.parametrize("B,Hc,Wc,Cin,Cu,Cs,Co,rb,cob", [
    (2, 8, 8, 64, 32, 32, 32, 8, None),
    (1, 16, 16, 128, 64, 64, 64, 16, None),
    (2, 4, 8, 32, 16, 16, 32, 16, 16),
    (1, 2, 8, 16, 16, 16, 16, 16, None),
])
def test_reference_matches_jax_kernel(B, Hc, Wc, Cin, Cu, Cs, Co, rb, cob):
    case = _rand_case(np.random.default_rng(0), B, Hc, Wc, Cin, Cu, Cs, Co)
    ref = jax_fused.fused_up_concat_conv(*map(jnp.asarray, case), row_block=rb,
                                         co_block=cob, interpret=True)
    got = k1.fused_up_concat_conv(*_port_args(*case))  # CPU tensors: plain version
    assert got.is_contiguous(memory_format=CL)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_pack_convt_kernel_matches_jax():
    wt = np.random.default_rng(1).standard_normal((2, 2, 16, 8)).astype(np.float32)
    ref = np.asarray(jax_fused.pack_convt_kernel(jnp.asarray(wt)))
    np.testing.assert_array_equal(k1.pack_convt_kernel(_convt_to_torch(wt)).numpy(), ref)


def test_pack_conv3x3_kernel_is_hwio_rows():
    wc = np.random.default_rng(2).standard_normal((3, 3, 24, 8)).astype(np.float32)
    np.testing.assert_array_equal(k1.pack_conv3x3_kernel(_conv_to_torch(wc)).numpy(),
                                  wc.reshape(9 * 24, 8))


def test_fold_conv_bn_matches_jax():
    rng = np.random.default_rng(3)
    cb, gamma, beta, mean = (rng.standard_normal(32).astype(np.float32) for _ in range(4))
    var = (rng.random(32) + 0.5).astype(np.float32)
    ref = jax_fused.fold_conv_bn(*map(jnp.asarray, (cb, gamma, beta, mean, var)))
    got = k1.fold_conv_bn(*map(torch.from_numpy, (cb, gamma, beta, mean, var)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def _kernel_args(**over):
    b, cin, hc, wc, cu, cs, co = 1, 64, 4, 6, 32, 32, 16
    a = dict(
        y=torch.zeros(b, cin, hc, wc, dtype=torch.bfloat16).contiguous(memory_format=CL),
        skip=torch.zeros(b, cs, 2 * hc, 2 * wc, dtype=torch.bfloat16
                         ).contiguous(memory_format=CL),
        wt=torch.zeros(cin, 4 * cu, dtype=torch.bfloat16), bt=torch.zeros(cu),
        wc=torch.zeros(9 * (cu + cs), co, dtype=torch.bfloat16),
        scale=torch.ones(co), bias=torch.zeros(co))
    a.update(over)
    return a


@pytest.mark.parametrize("over,err", [
    ({}, None),
    ({"skip": torch.zeros(1, 32, 8, 11, dtype=torch.bfloat16)}, ValueError),   # not 2x
    ({"y": torch.zeros(1, 64, 4, 6)}, TypeError),                              # f32 y
    ({"y": torch.zeros(1, 64, 4, 6, dtype=torch.bfloat16)[..., :6]
      .contiguous()}, ValueError),                                             # NCHW memory
    ({"wt": torch.zeros(64, 4 * 48, dtype=torch.bfloat16), "bt": torch.zeros(48),
      "wc": torch.zeros(9 * 80, 16, dtype=torch.bfloat16)}, ValueError),       # Cu % 32
    ({"wc": torch.zeros(9 * 64, 12, dtype=torch.bfloat16), "scale": torch.ones(12),
      "bias": torch.zeros(12)}, ValueError),                                   # Co % 8
    ({"scale": torch.ones(16, dtype=torch.bfloat16)}, TypeError),              # bf16 scale
])
def test_kernel_argument_checks(over, err):
    a = _kernel_args(**over)
    if err is None:
        assert k1._check_kernel_args(**a) == (1, 64, 4, 6, 32, 32, 16)
    else:
        with pytest.raises(err):
            k1._check_kernel_args(**a)


def test_wrapper_rejects_other_devices():
    a = _kernel_args()
    a["y"] = a["y"].to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k1.fused_up_concat_conv(**a)


def _jax_stage(rng, cin, cout, x, skip):
    v = flax.core.unfreeze(JaxUpSampleUNet(cout, cin // 2).init(jax.random.PRNGKey(0), x, skip))
    for cna in ("ConvNormAct_0", "ConvNormAct_1"):
        bnp = v["params"]["DoubleConv_0"][cna]["BatchNorm_0"]
        bnst = v["batch_stats"]["DoubleConv_0"][cna]["BatchNorm_0"]
        bnst["mean"] = jnp.asarray(rng.standard_normal(bnst["mean"].shape) * 0.1, jnp.float32)
        bnst["var"] = jnp.asarray(rng.random(bnst["var"].shape) + 0.5, jnp.float32)
        bnp["scale"] = jnp.asarray(rng.random(bnp["scale"].shape) + 0.5, jnp.float32)
        bnp["bias"] = jnp.asarray(rng.standard_normal(bnp["bias"].shape) * 0.1, jnp.float32)
    return v


def _load_stage(mod, v):
    p, s = v["params"], v["batch_stats"]
    sd = {}
    ct = p["TransposedUp_0"]["ConvTranspose_0"]
    sd["up.weight"], sd["up.bias"] = _convt_to_torch(ct["kernel"]), torch.tensor(
        np.asarray(ct["bias"]))
    for i, idx in enumerate((0, 3)):
        cna, st = p["DoubleConv_0"][f"ConvNormAct_{i}"], s["DoubleConv_0"][f"ConvNormAct_{i}"]
        pre = f"conv.conv_op.{idx}"
        sd[f"{pre}.weight"] = _conv_to_torch(cna["Conv_0"]["kernel"])
        sd[f"{pre}.bias"] = torch.tensor(np.asarray(cna["Conv_0"]["bias"]))
        bn = f"conv.conv_op.{idx + 1}"
        for k, src in (("weight", cna["BatchNorm_0"]["scale"]),
                       ("bias", cna["BatchNorm_0"]["bias"]),
                       ("running_mean", st["BatchNorm_0"]["mean"]),
                       ("running_var", st["BatchNorm_0"]["var"])):
            sd[f"{bn}.{k}"] = torch.tensor(np.asarray(src))
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    mod.load_state_dict(sd, strict=True)
    return mod.eval()


@pytest.mark.parametrize("use_kernels", [True, False])
def test_upsample_unet_matches_jax(use_kernels):
    """Kernel path against JAX use_pallas=True (interpret), module path
    against use_pallas=False; BN stats and affine moved off identity."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 64)).astype(np.float32)
    skip = rng.standard_normal((1, 16, 16, 32)).astype(np.float32)
    v = _jax_stage(rng, 64, 32, jnp.asarray(x), jnp.asarray(skip))
    ref = JaxUpSampleUNet(32, 32, use_pallas=use_kernels).apply(v, jnp.asarray(x),
                                                                jnp.asarray(skip))
    mod = _load_stage(UpSampleUNet(64, 32, use_kernels=use_kernels), v)
    assert mod.kernel_path(_nchw(x), _nchw(skip)) is use_kernels
    with torch.no_grad():
        got = mod(_nchw(x), _nchw(skip))
        mod.freeze_kernel_weights()
        frozen = mod(_nchw(x), _nchw(skip))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(frozen.numpy(), got.numpy())


def test_kernel_path_dispatch():
    mod = UpSampleUNet(64, 32).eval()
    x, skip = torch.zeros(1, 64, 4, 4), torch.zeros(1, 32, 8, 8)
    assert not mod.kernel_path(x, skip)              # auto: bf16 CUDA only
    mod.use_kernels = True
    assert mod.kernel_path(x, skip)
    assert not mod.kernel_path(x, torch.zeros(1, 32, 9, 8))   # not 2x: module path
    mod.train()
    assert not mod.kernel_path(x, skip)
