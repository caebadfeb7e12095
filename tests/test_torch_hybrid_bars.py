"""The card's bars for random-weight da_transformer and egeunet, held against
how far the JAX package itself strays on the same weights (CPU).

``chip_smoke.py`` serves the port's seed-0 ``da_transformer`` (registry
default, its six attention gammas at 0.5) in bf16 against float32 compute,
and int8 against float. Its ResNetV2 (weight-standardised convs, GroupNorm,
16 residual units) parts a perturbation of the last bits about 30-fold by
its last unit, and the decoder carries that to the logits, so JAX's own bf16
and int8 logits lie far beyond phase 22's 3e-2 and JAX's 0.10 bars on these
weights. Here both frameworks read both distances on the same weights,
carried into JAX by its converter, at 64px: the port's lie no further than
1.25 times JAX's, and the card's per-name bars (``CORE_BARS``,
``INT8_FLOAT_BARS``) lie above JAX's distances and below its mask
agreements. (At 256px JAX reads 0.558 and 0.443, masks 0.929 and 0.941;
the bars are also at least 1.25 times those.) egeunet's bf16 strays
beyond 3e-2 too, in both frameworks: its channels are 8-64 wide, and each
LayerNorm and GELU rounds to bf16 after a few products.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from test_torch_core_members import _nhwc, _rel
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu.utils.serving import calibrate_int8 as jax_calibrate_int8
from unet_zoo_tpu.utils.serving import cast_params_for_inference as jax_cast
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.utils.serving import calibrate_int8, make_predictor

torch.set_num_threads(1)

SIZE = 64


def _agree(a, b):
    return float(np.mean((a > 0) == (b > 0)))


@functools.lru_cache(maxsize=None)
def served():
    """The port's seed-0 da_transformer as chip_smoke builds it (float32
    and bf16), three seeded 64px batches of 2, and JAX's variables of the
    same weights."""
    port = create_model("da_transformer", device="cpu", seed=0)
    with torch.no_grad():
        for name in chip_smoke.DA_GAMMAS:
            port.module.get_submodule(name).gamma.fill_(chip_smoke.PAM_GAMMA)
    bf16 = create_model("da_transformer", device="cpu", seed=0, dtype=torch.bfloat16)
    bf16.module.load_state_dict(port.module.state_dict())
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 3, SIZE, SIZE, generator=g) for _ in range(3)]
    v = convert_state_dict("da_transformer", dict(port.module.state_dict()))
    return port, bf16, xs, v


def _jax_logits(dtype, variables, x):
    m = jax_create_model("da_transformer", dtype=dtype)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
    return np.asarray(apply(jax_cast(variables), jnp.asarray(_nhwc(x))), np.float32)


def test_bf16_strays_from_float32_as_far_as_jax():
    """bf16 against float32 compute on the same bf16-rounded weights (read:
    port 0.588, masks 0.887; JAX 0.640, 0.886)."""
    port, bf16, xs, v = served()
    x = xs[0]
    port_f32 = _nhwc(make_predictor(port, None, "logits")(x))
    port_bf16 = _nhwc(make_predictor(bf16, None, "logits")(x))
    jax_f32, jax_bf16 = (_jax_logits(dt, v, x) for dt in (jnp.float32, jnp.bfloat16))
    jax_rel, jax_agree = _rel(jax_bf16, jax_f32), _agree(jax_bf16, jax_f32)
    rel_bar, agree_bar = chip_smoke.CORE_BARS["da_transformer"]
    assert jax_rel > chip_smoke.CORE_REL_L2
    assert _rel(port_bf16, port_f32) <= 1.25 * jax_rel, (_rel(port_bf16, port_f32), jax_rel)
    assert _agree(port_bf16, port_f32) >= agree_bar
    assert rel_bar >= jax_rel and agree_bar <= jax_agree, (jax_rel, jax_agree)


def test_int8_strays_from_float_as_far_as_jax():
    """int8 against float, each side calibrated on the same two batches and
    serving a third, weights bf16-rounded as served (read: port 0.459, masks
    0.932; JAX 0.539, 0.905)."""
    port, _, xs, v = served()
    m = jax_create_model("da_transformer")
    vq = jax_calibrate_int8(m, v, [jnp.asarray(_nhwc(x)) for x in xs[:2]])
    jax_float, jax_int8 = (_jax_logits(jnp.float32, w, xs[2]) for w in (v, vq))
    stats = calibrate_int8(port, xs[:2])
    port_float, port_int8 = (_nhwc(make_predictor(port, None, "logits", quant=q)(xs[2]))
                             for q in (None, stats))
    jax_rel, jax_agree = _rel(jax_int8, jax_float), _agree(jax_int8, jax_float)
    rel_bar, agree_bar = chip_smoke.INT8_FLOAT_BARS["da_transformer"]
    assert jax_rel > chip_smoke.INT8_FLOAT_REL_L2
    assert _rel(port_int8, port_float) <= 1.25 * jax_rel, (_rel(port_int8, port_float), jax_rel)
    assert _agree(port_int8, port_float) >= agree_bar
    assert rel_bar >= jax_rel and agree_bar <= jax_agree, (jax_rel, jax_agree)


def test_egeunet_bf16_strays_from_float32_as_far_as_jax():
    """The port's seed-0 egeunet built for 64px, bf16 against float32 compute
    on the same bf16-rounded weights, four seeded images (read: port 0.0549,
    masks 0.986; JAX 0.0789, 0.977; at 256px JAX 0.0554, 0.984)."""
    port = create_model("egeunet", device="cpu", seed=0, image_size=SIZE)
    bf16 = create_model("egeunet", device="cpu", seed=0, image_size=SIZE, dtype=torch.bfloat16)
    x = torch.randn(4, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    port_f32, port_bf16 = (_nhwc(make_predictor(m, None, "logits")(x)) for m in (port, bf16))
    v = jax_cast(convert_state_dict("egeunet", dict(port.module.state_dict())))
    jax_out = []
    for dtype in (jnp.float32, jnp.bfloat16):
        m = jax_create_model("egeunet", dtype=dtype, image_size=SIZE)
        apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
        jax_out.append(np.asarray(apply(v, jnp.asarray(_nhwc(x))), np.float32))
    jax_rel, jax_agree = _rel(jax_out[1], jax_out[0]), _agree(jax_out[1], jax_out[0])
    rel_bar, agree_bar = chip_smoke.CORE_BARS["egeunet"]
    assert _rel(port_f32, jax_out[0]) <= 1e-3
    assert jax_rel > chip_smoke.CORE_REL_L2
    assert _rel(port_bf16, port_f32) <= 1.25 * jax_rel, (_rel(port_bf16, port_f32), jax_rel)
    assert _agree(port_bf16, port_f32) >= agree_bar
    assert rel_bar >= jax_rel and agree_bar <= jax_agree, (jax_rel, jax_agree)
