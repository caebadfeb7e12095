"""egeunet in the port against the JAX package (CPU, float32): the whole
model at 64px (``image_size=64``) in all four bridge / deep-supervision
combinations, every output key; GHPA and GAB alone; one train step; the
converters; and the int8 refusal. The original EGE-UNet class cannot be
built (``tests/test_parity6.py::test_egeunet_reference_is_broken``), so the
JAX model is the only oracle.

The variables come from ``jax.eval_shape`` of JAX's init, every leaf drawn
from a numpy generator (``test_torch_conv_members.jax_member_variables``);
GHPA's grids, ones at init, are drawn around one (``_grids_off_one``), so
that each group's Hadamard factor varies over its axes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_core_members as core
from test_torch_conv_members import jax_member_variables, jax_module_variables
from test_torch_core_members import _nchw, _nhwc
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models.egeunet import GAB, GHPA
from unet_zoo_tpu_torch.utils.convert import _ghpa, _ln, _conv, from_jax_variables
from unet_zoo_tpu_torch.utils.serving import calibrate_int8

torch.set_num_threads(1)

SIZE = 64
SIDES = ["side1", "side2", "side3", "side4", "side5"]


def _grids_off_one(tree, rng):
    """Every GHPA grid (``params_xy/zx/zy``) redrawn as 1 + 0.5 N(0, 1)."""
    def redraw(path, leaf):
        name = getattr(path[-1], "key", None)
        if name is not None and name.startswith("params_"):
            return (1.0 + 0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(redraw, tree)


@functools.lru_cache(maxsize=None)
def member(bridge=True, gt_ds=True):
    kw = {"image_size": SIZE, "bridge": bridge, "gt_ds": gt_ds}
    m, v = jax_member_variables("egeunet", SIZE, **kw)
    v = {"params": _grids_off_one(v["params"], np.random.default_rng(1)), "batch_stats": {}}
    x = np.random.default_rng(SIZE).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False))
    want = {k: np.asarray(o) for k, o in apply(v, jnp.asarray(x)).items()}
    return dict(name="egeunet", kw=kw, m=m, v=v, x=x, apply=apply, want=want)


@pytest.mark.parametrize("bridge", [True, False])
@pytest.mark.parametrize("gt_ds", [True, False])
def test_forward_matches_jax(bridge, gt_ds):
    """Every output key within 1e-3 rel L2 of JAX's, at the input's size:
    'main' and 'side1'-'side5' with deep supervision, 'main' alone without
    (the bridges then take a mask of ones)."""
    c = member(bridge, gt_ds)
    assert sorted(c["want"]) == sorted(["main"] + (SIDES if gt_ds else []))
    core.check_forward(c)


def test_converters_invert_jax_converters():
    """from_jax_variables inverts JAX's ``convert_egeunet`` (the original
    EGE-UNet's names, the grids in its [1, c, a, b] and [1, 1, c, L]
    layouts) exactly, both ways."""
    port = create_model("egeunet", device="cpu", seed=3, image_size=SIZE)
    sd = port.module.state_dict()
    assert tuple(sd["encoder4.0.params_zx"].shape) == (1, 1, 6, 4)
    assert tuple(sd["decoder3.0.params_xy"].shape) == (1, 8, 8, 8)
    v = convert_state_dict("egeunet", dict(sd))
    back = from_jax_variables("egeunet", v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    again = convert_state_dict("egeunet", back)
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, v)


@pytest.mark.parametrize("bridge,gt_ds", [(False, False), (True, False)])
def test_converter_reads_what_the_variables_hold(bridge, gt_ds):
    """Without the bridges or the deep-supervision heads, JAX has no GAB or
    gt_conv variables and the port no such modules: the converter carries
    what there is, and the model loads it strictly."""
    m, v = jax_member_variables("egeunet", SIZE, image_size=SIZE, bridge=bridge, gt_ds=gt_ds)
    sd = from_jax_variables("egeunet", v)
    assert any(k.startswith("GAB") for k in sd) == bridge
    assert not any(k.startswith("gt_conv") for k in sd)
    port = create_model("egeunet", device="cpu", image_size=SIZE, bridge=bridge, gt_ds=gt_ds)
    port.module.load_state_dict(sd, strict=True)


def test_train_step_matches_jax():
    """One step from the same variables and batch: loss over 'main' (1.0)
    and the five sides (0.5 each), Dice, every gradient
    within 1e-2 of its tensor's largest entry (``check_train_step``,
    directly; GroupNorm and LayerNorm, no running statistics)."""
    core.check_train_step(member(), conditioned=False)


def test_registry_defaults_match_jax():
    """image_size 512 by default (grids of 64, 32 and 16), JAX's parameter
    count there (0.11 M), the loss weights main 1.0, sides 0.5."""
    port = create_model("egeunet", device="cpu")
    jm = jax_create_model("egeunet")
    assert port.image_size == jm.image_size == 512
    assert tuple(port.module.encoder4[0].params_xy.shape) == (1, 6, 32, 32)
    assert tuple(port.module.decoder3[0].params_xy.shape) == (1, 8, 64, 64)
    assert tuple(port.module.encoder6[0].params_zy.shape) == (1, 1, 12, 16)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3))))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in port.module.parameters()) == n_jax
    assert [port.loss_weight(k) for k in ["main"] + SIDES] == [1.0] + [0.5] * 5
    assert [jm.loss_weight(k) for k in ["main"] + SIDES] == [1.0] + [0.5] * 5


def test_int8_calibration_raises_as_jax():
    """No conv of egeunet is int8-gated (JAX's are plain convs), so
    ``calibrate_int8`` raises on both sides."""
    from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8

    c = member()
    with pytest.raises(ValueError, match="no quantizable convs"):
        jax_calibrate_int8(c["m"], c["v"], [jnp.asarray(c["x"][:1])])
    with pytest.raises(ValueError, match="no quantizable convs"):
        calibrate_int8(core.port_model(c["name"], c["v"], **c["kw"]), [_nchw(c["x"][:1])])


# --- modules ---------------------------------------------------------------------


def _jax_vars(module, *inputs):
    v = jax_module_variables(module, *inputs)
    return {"params": _grids_off_one(v["params"], np.random.default_rng(1))}


@pytest.mark.parametrize("hw,c_in,c_out,res", [((16, 16), 24, 32, 8), ((9, 13), 32, 48, 5)])
def test_ghpa_matches_jax(hw, c_in, c_out, res):
    """GHPA: each grid resized to its map (a square map and an odd
    non-square one, from grids larger and smaller than it), refined, and
    broadcast over its axes; group 4's 1x1 -> GELU -> depthwise; the tail."""
    from unet_zoo_tpu.models.egeunet import GHPA as JaxGHPA

    x = np.random.default_rng(c_in).standard_normal((2, *hw, c_in)).astype(np.float32)
    j = JaxGHPA(c_in, c_out, res, res + 3)
    v = _jax_vars(j, jnp.asarray(x))
    want = np.asarray(j.apply(v, jnp.asarray(x)))
    port = GHPA(c_in, c_out, res, res + 3)
    sd = {}
    _ghpa(sd, "", v["params"])
    port.load_state_dict({k[1:]: t for k, t in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dim_xl,mask", [(8, "drawn"), (24, "ones")])
def test_gab_matches_jax(dim_xl, mask):
    """GAB: xh projected and resized (11 x 11 -> 22 x 21), four dilated
    depthwise groups of dim_xl / 4 * 2 + 1 channels with the mask, the tail."""
    from unet_zoo_tpu.models.egeunet import GAB as JaxGAB

    rng = np.random.default_rng(dim_xl)
    xh = rng.standard_normal((2, 11, 11, 2 * dim_xl)).astype(np.float32)
    xl = rng.standard_normal((2, 22, 21, dim_xl)).astype(np.float32)
    m = (rng.standard_normal((2, 22, 21, 1)) if mask == "drawn"
         else np.ones((2, 22, 21, 1))).astype(np.float32)
    j = JaxGAB(dim_xl)
    v = _jax_vars(j, jnp.asarray(xh), jnp.asarray(xl), jnp.asarray(m))
    want = np.asarray(j.apply(v, jnp.asarray(xh), jnp.asarray(xl), jnp.asarray(m)))
    port = GAB(2 * dim_xl, dim_xl)
    p, sd = v["params"], {}
    _conv(sd, "pre_project", p["pre_project"])
    for k in range(4):
        _ln(sd, f"g{k}.0", p[f"g{k}_norm"])
        _conv(sd, f"g{k}.1", p[f"g{k}_conv"])
    _ln(sd, "tail_conv.0", p["tail_norm"])
    _conv(sd, "tail_conv.1", p["tail_conv"])
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(_nchw(xh), _nchw(xl), _nchw(m))
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-5)
