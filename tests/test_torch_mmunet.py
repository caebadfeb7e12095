"""mmunet in the port against the JAX package (CPU).

K4 (``fused_mkblock``) and K5 (``fused_softmax_morph``): on the CPU the
port's wrappers run their plain versions, held here against the JAX Pallas
kernels in interpret mode at the shapes the JAX package's own tests use. The
CUDA kernels themselves are held against the plain versions by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` on the card.
The whole model (``base_channels=16``, 64x64, B=1) runs against the JAX
eval forward, whose CPU path (the XLA one) is the whole-model oracle.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.models.mmunet import GroupedConv2in as JaxGroupedConv2in
from unet_zoo_tpu.models.mmunet import MKBlock as JaxMKBlock
from unet_zoo_tpu.ops.pallas import mkblock as jax_mkblock
from unet_zoo_tpu.ops.pallas import morph as jax_morph
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import make_predictor as jax_make_predictor
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.mmunet import GroupedConv2in, MKBlock
from unet_zoo_tpu_torch.ops.kernels import mkblock as k4
from unet_zoo_tpu_torch.ops.kernels import morph as k5
from unet_zoo_tpu_torch.ops.kernels import use_kernel
from unet_zoo_tpu_torch.utils import convert as port_convert
from unet_zoo_tpu_torch.utils.convert import from_jax_variables
from unet_zoo_tpu_torch.utils.serving import cast_params_for_inference, make_predictor

torch.set_num_threads(1)

CL = torch.channels_last


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _perturb(rng, params, stats):
    """Move every BatchNorm's statistics and affine off identity."""
    if "mean" in stats:
        stats["mean"] = jnp.asarray(rng.standard_normal(stats["mean"].shape) * 0.1, jnp.float32)
        stats["var"] = jnp.asarray(rng.random(stats["var"].shape) + 0.5, jnp.float32)
        params["scale"] = jnp.asarray(rng.random(params["scale"].shape) + 0.5, jnp.float32)
        params["bias"] = jnp.asarray(rng.standard_normal(params["bias"].shape) * 0.1,
                                     jnp.float32)
        return
    for k in stats:
        _perturb(rng, params[k], stats[k])


def _jax_block(dim, ext, x, seed=0):
    """JAX MKBlock variables (numpy leaves) with BN moved off identity and
    nonzero depthwise and dense biases."""
    rng = np.random.default_rng(seed)
    v = flax.core.unfreeze(JaxMKBlock(dim, ext, use_pallas=False).init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=False))
    _perturb(rng, v["params"], v["batch_stats"])
    for name in ("dwconv1", "dwconv2", "dwconv3", "pwconv1", "pwconv2"):
        b = v["params"][name]["bias"]
        v["params"][name]["bias"] = jnp.asarray(rng.standard_normal(b.shape) * 0.1, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, v)


def _port_block(dim, ext, v, use_kernels):
    sd = {}
    port_convert._mkblock(sd, "b", v["params"], v["batch_stats"])
    blk = MKBlock(dim, ext, use_kernels=use_kernels)
    blk.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    return blk.eval()


# --- K4 -------------------------------------------------------------------


def test_fold_mkblock_params_matches_jax():
    dim = 16
    x = np.random.default_rng(1).standard_normal((1, 8, 8, dim)).astype(np.float32)
    v = _jax_block(dim, False, x)
    ref = jax_mkblock.fold_mkblock_params(v["params"], v["batch_stats"], dim)
    got = k4.fold_mkblock_params(_port_block(dim, False, v, False))
    q = dim // 4
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    want = {"taps": f32(ref[0]).reshape(83, q), "affine": f32(ref[1]).reshape(6, q),
            "w1": f32(ref[2]).T, "b1": f32(ref[3])[:, 0],
            "w2": f32(ref[4])[:dim].T, "b2": f32(ref[5])[:, 0]}
    assert got.w1.dtype == got.w2.dtype == torch.bfloat16
    for name, w in want.items():
        g = getattr(got, name).float().numpy()
        assert g.shape == w.shape, name
        # float32 folds; b1 is a [C] x [C, 4C] product summed in another order
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)


# the parameter sets of tests/test_mkblock.py::test_fused_mkblock_matches_xla
@pytest.mark.parametrize("dim,h,w,rows", [(8, 16, 128, 8), (8, 8, 128, 8), (16, 24, 256, 8)])
def test_mkblock_reference_matches_jax_kernel(dim, h, w, rows):
    """Both sides take the same bf16 input and round h0 and the hidden layer
    to bf16; JAX's output is bf16 as well. Tolerance: one bf16 rounding of
    the output (2^-9 relative) plus the rare h0/hidden element whose f32
    value lands on the other side of a bf16 rounding boundary (the two sum
    in other orders, and JAX's erf is a 1.5e-7 polynomial):
    1e-2 * max(1, |ref|)."""
    x = np.random.default_rng(2).standard_normal((2, h, w, dim)).astype(np.float32)
    v = _jax_block(dim, False, x)
    ops = jax_mkblock.fold_mkblock_params(v["params"], v["batch_stats"], dim)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax_mkblock.fused_mkblock(xb.transpose(0, 1, 3, 2), *ops, row_block=rows,
                                    interpret=True)
    ref = np.asarray(ref.transpose(0, 1, 3, 2).astype(jnp.float32))
    w_port = k4.fold_mkblock_params(_port_block(dim, False, v, True))
    x_port = _nchw(np.asarray(xb.astype(jnp.float32)))            # bf16-exact values
    got = _nhwc(k4.fused_mkblock(x_port, *w_port))                 # CPU: plain version
    assert np.abs(got - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())
    bf16_in = k4.fused_mkblock(x_port.to(torch.bfloat16), *w_port)
    assert bf16_in.dtype == torch.bfloat16 and bf16_in.is_contiguous(memory_format=CL)


@pytest.mark.parametrize("ext", [False, True])
def test_mkblock_module_path_matches_jax(ext):
    """Module path against JAX MKBlock(use_pallas=False), f32, with and
    without the external-attention tail: same arithmetic, 1e-4."""
    dim = 16
    x = np.random.default_rng(3).standard_normal((2, 8, 12, dim)).astype(np.float32)
    v = _jax_block(dim, ext, x)
    ref = JaxMKBlock(dim, ext, use_pallas=False).apply(v, jnp.asarray(x), train=False)
    blk = _port_block(dim, ext, v, False)
    assert not blk.kernel_path(_nchw(x))
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ext", [False, True])
def test_mkblock_kernel_path_matches_jax(ext):
    """Kernel path (its plain version on the CPU) against JAX
    MKBlock(use_pallas=True) in interpret mode, EA tail after it in both;
    tolerance as for the kernel: 1e-2 * max(1, |ref|)."""
    dim = 32
    x = np.random.default_rng(4).standard_normal((1, 8, 128, dim)).astype(np.float32)
    v = _jax_block(dim, ext, x)
    ref = np.asarray(JaxMKBlock(dim, ext, use_pallas=True).apply(v, jnp.asarray(x), train=False))
    blk = _port_block(dim, ext, v, True)
    assert blk.kernel_path(_nchw(x))
    with torch.no_grad():
        got = _nhwc(blk(_nchw(x)))
        blk.freeze_kernel_weights()
        frozen = _nhwc(blk(_nchw(x)))
    assert np.abs(got - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())
    np.testing.assert_array_equal(frozen, got)


def _k4_args(**over):
    c, q = 32, 8
    a = dict(x=torch.zeros(1, c, 5, 7, dtype=torch.bfloat16).contiguous(memory_format=CL),
             taps=torch.zeros(83, q), affine=torch.zeros(6, q),
             w1=torch.zeros(c, 4 * c, dtype=torch.bfloat16), b1=torch.zeros(4 * c),
             w2=torch.zeros(4 * c, c, dtype=torch.bfloat16), b2=torch.zeros(c))
    a.update(over)
    return a


@pytest.mark.parametrize("over,err", [
    ({}, None),
    ({"x": torch.zeros(1, 32, 5, 7).contiguous(memory_format=CL)}, TypeError),   # f32 x
    ({"x": torch.zeros(1, 32, 5, 7, dtype=torch.bfloat16)}, ValueError),        # NCHW memory
    ({"x": torch.zeros(1, 24, 5, 7, dtype=torch.bfloat16
                       ).contiguous(memory_format=CL)}, ValueError),            # C % 32
    ({"w1": torch.zeros(32, 96, dtype=torch.bfloat16)}, ValueError),            # not [C, 4C]
    ({"b2": torch.zeros(32, dtype=torch.bfloat16)}, TypeError),                 # bf16 bias
    ({"taps": torch.zeros(8, 83).t()}, ValueError),                             # not contiguous
])
def test_mkblock_kernel_argument_checks(over, err):
    a = _k4_args(**over)
    if err is None:
        assert k4._check_kernel_args(**a) == (1, 32, 5, 7)
    else:
        with pytest.raises(err):
            k4._check_kernel_args(**a)


# --- K5 -------------------------------------------------------------------


# the parameter sets of tests/test_morph.py::test_fused_morph_matches_xla
@pytest.mark.parametrize("repeat", [1, 2])
@pytest.mark.parametrize("shape", [(2, 32, 128, 16), (1, 24, 256, 8)])
def test_morph_reference_matches_jax_kernel(shape, repeat):
    """f32 softmax and exact max/min on both sides: 1e-6."""
    b, h, w, c = shape
    x = (np.random.default_rng(repeat).standard_normal(shape) * 2.0).astype(np.float32)
    d_ref, e_ref = jax_morph.fused_softmax_morph(jnp.asarray(x).transpose(0, 1, 3, 2), k=7,
                                                 repeat=repeat, interpret=True)
    d, e = k5.fused_softmax_morph(_nchw(x), 7, repeat)                # CPU: plain version
    assert d.is_contiguous(memory_format=CL) and e.is_contiguous(memory_format=CL)
    np.testing.assert_allclose(_nhwc(d), np.asarray(d_ref).transpose(0, 1, 3, 2), atol=1e-6)
    np.testing.assert_allclose(_nhwc(e), np.asarray(e_ref).transpose(0, 1, 3, 2), atol=1e-6)


def test_morph_reference_k3():
    """Non-default k, as tests/test_morph.py::test_fused_morph_small_rows_and_k3."""
    x = np.random.default_rng(3).standard_normal((1, 12, 128, 8)).astype(np.float32)
    d_ref, e_ref = jax_morph.fused_softmax_morph(jnp.asarray(x).transpose(0, 1, 3, 2), k=3,
                                                 repeat=1, row_block=8, interpret=True)
    d, e = k5.fused_softmax_morph(_nchw(x), 3, 1)
    np.testing.assert_allclose(_nhwc(d), np.asarray(d_ref).transpose(0, 1, 3, 2), atol=1e-6)
    np.testing.assert_allclose(_nhwc(e), np.asarray(e_ref).transpose(0, 1, 3, 2), atol=1e-6)


@pytest.mark.parametrize("shape,k,repeat,err", [
    ((1, 16, 5, 7), 7, 2, None),
    ((1, 12, 5, 7), 7, 1, ValueError),      # C % 8
    ((1, 16, 5, 7), 6, 1, ValueError),      # even k
    ((1, 16, 5, 7), 7, 0, ValueError),      # no round
    ((1, 16, 5, 7), 7, 3, ValueError),      # a third round: no instance of the kernel
    ((1, 16, 5, 7), 3, 1, ValueError),      # the kernel's window is mmunet's 7
])
def test_morph_kernel_argument_checks(shape, k, repeat, err):
    x = torch.zeros(shape, dtype=torch.bfloat16).contiguous(memory_format=CL)
    if err is None:
        assert k5._check_kernel_args(x, k, repeat) == shape
    else:
        with pytest.raises(err):
            k5._check_kernel_args(x, k, repeat)
    with pytest.raises(TypeError):
        k5._check_kernel_args(x.float(), 7, 1)


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 32, 4, 4, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k5.fused_softmax_morph(x)
    a = _k4_args()
    a["x"] = x
    with pytest.raises(ValueError, match="cuda or cpu"):
        k4.fused_mkblock(**a)


# --- modules ----------------------------------------------------------------


def test_grouped_conv2in_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 9, 7, 16)).astype(np.float32)
    v = JaxGroupedConv2in(8).init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = JaxGroupedConv2in(8).apply(v, jnp.asarray(x))
    mod = GroupedConv2in(8)
    mod.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
    with torch.no_grad():
        got = _nhwc(mod(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_use_kernel_dispatch():
    x = torch.zeros(1, 32, 4, 4)
    assert not use_kernel(None, False, x)                  # auto: bf16 CUDA only
    assert use_kernel(True, False, x)
    assert not use_kernel(True, True, x)                   # training
    assert not use_kernel(False, False, x)
    assert not use_kernel(True, False, x, fits=False)      # outside the shape gate
    z = torch.zeros(1, 16, 4, 4)
    assert not MKBlock(16, use_kernels=True).eval().kernel_path(z)   # C % 32: module path
    blocks = [m for m in create_model("mmunet", device="cpu", base_channels=16,
                                      use_kernels=True).module.modules()
              if isinstance(m, MKBlock)]
    # base 16: the 16-channel blocks (first_down, up4, up5) take the module path
    assert sum(b.kernel_path(torch.zeros(1, b.dim, 4, 4)) for b in blocks) == 22 - 6


# --- the whole model ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mmunet():
    """JAX mmunet (base_channels=16) variables with BN moved off identity,
    its input and its eval logits."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    m = jax_create_model("mmunet", base_channels=16)
    v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    _perturb(rng, v["params"], v["batch_stats"])
    v = jax.tree_util.tree_map(np.asarray, v)
    ref = np.asarray(m.module.apply(v, jnp.asarray(x), train=False)["main"])
    return m, v, x, ref


def _port(v, use_kernels):
    m = create_model("mmunet", device="cpu", base_channels=16, use_kernels=use_kernels)
    m.module.load_state_dict(from_jax_variables("mmunet", v), strict=True)
    return m


def test_eval_logits_match_jax_module_path(jax_mmunet):
    _, v, x, ref = jax_mmunet
    with torch.no_grad():
        got = _nhwc(_port(v, False).module(_nchw(x))["main"])
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_eval_logits_match_jax_kernel_path(jax_mmunet):
    """Kernel path (plain versions on the CPU): every MKBlock rounds its
    input, h0, hidden layer and output to bf16, as the JAX package's fused
    path does, and every morphology gate its input, dilation and erosion;
    the JAX oracle on the CPU is its f32 XLA path. Tolerance: relative L2
    of logits <= 3e-2 (22 blocks and 6 gates of bf16 rounding)."""
    _, v, x, ref = jax_mmunet
    before = (k4.LAUNCHES["fused_mkblock"], k5.LAUNCHES["fused_softmax_morph"])
    with torch.no_grad():
        got = _nhwc(_port(v, True).module(_nchw(x))["main"])
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 3e-2
    # the CPU runs the plain versions: no kernel launch is counted
    assert (k4.LAUNCHES["fused_mkblock"], k5.LAUNCHES["fused_softmax_morph"]) == before


def test_state_dict_keys_round_trip(jax_mmunet):
    _, v, _, _ = jax_mmunet
    sd = _port(v, None).module.state_dict()
    back = convert_state_dict("mmunet", {k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)
                         for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_predictor_probs_match_jax(jax_mmunet):
    """bf16-rounded weights, f32 compute, module path (the CPU default):
    sigmoid probabilities against the JAX predictor at 2e-3."""
    jm, v, x, _ = jax_mmunet
    m = _port(v, None)
    probs_ref = np.asarray(jax_make_predictor(jm, v, "probs")(jnp.asarray(x)))
    probs = _nhwc(make_predictor(m, None, "probs")(_nchw(x)))
    np.testing.assert_allclose(probs, probs_ref, rtol=2e-3, atol=2e-3)


def test_predictor_freezes_kernel_weights(jax_mmunet):
    """make_predictor folds every MKBlock once; the frozen kernel path gives
    the same logits as folding at each call."""
    _, v, x, _ = jax_mmunet
    m = _port(v, True)
    assert sum(isinstance(mod, MKBlock) for mod in m.module.modules()) == 22
    logits = make_predictor(m, None, "logits")(_nchw(x))
    with torch.no_grad():
        direct = cast_params_for_inference(m.module)(_nchw(x))["main"]  # folds per call
    np.testing.assert_array_equal(logits.numpy(), direct.numpy())
