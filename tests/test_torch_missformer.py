"""missformer in the port against the JAX package (CPU).

The JAX model's variables are drawn from numpy over the shapes of its init
(``jax.eval_shape``: no init is run), once for the file, and carried to the
port by ``from_jax_variables``. Eval logits at 64px and 32px (where the four
stages are 8, 4, 2 and 1 pixels), for three-channel and grayscale input, on
the module path and on the kernel path (K3's plain version on the CPU: 32
calls a forward); the ``state_dict`` read back by JAX's converter; one train
step (loss and every clipped gradient). The CUDA kernel itself is held
against the plain version by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.train.steps import TrainState as JaxTrainState
from unet_zoo_tpu.train.steps import make_optimizer as jax_make_optimizer
from unet_zoo_tpu.train.steps import make_train_step as jax_make_train_step
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.models import missformer as pmf
from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

CL = torch.channels_last


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _draw(rng, name, shape):
    """A seeded value for one JAX variable: kernels at LeCun scale, LayerNorm
    scales in [0.5, 1.5), biases near zero."""
    if name == "kernel":
        return rng.standard_normal(shape) * np.sqrt(1.0 / int(np.prod(shape[:-1])))
    if name == "scale":
        return rng.random(shape) + 0.5
    return rng.standard_normal(shape) * 0.1


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX missformer (registry defaults), its variables drawn by _draw
    over the init's shapes, and its jitted eval forward."""
    m = jax_create_model("missformer", image_size=64)
    shapes = jax.eval_shape(lambda: m.module.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(0)
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    drawn = [_draw(rng, path[-1].key, leaf.shape).astype(np.float32) for path, leaf in leaves]
    v = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), drawn)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
    return m, {"params": v["params"]}, apply


@functools.lru_cache(maxsize=None)
def _jax_logits(size, channels):
    """A seeded batch of 2 and the JAX eval logits."""
    _, v, apply = _jax_model()
    x = np.random.default_rng(size + channels).standard_normal(
        (2, size, size, channels)).astype(np.float32)
    return x, np.asarray(apply(v, jnp.asarray(x)))


def _port(in_channels=3, **kw):
    _, v, _ = _jax_model()
    m = create_model("missformer", device="cpu", in_channels=in_channels, image_size=64, **kw)
    m.module.load_state_dict(from_jax_variables("missformer", v), strict=True)
    return m


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("size,channels", [(64, 3), (64, 1), (32, 3), (32, 1)])
def test_eval_logits_match_jax(size, channels, use_kernels):
    """Module path and kernel path (the plain K3 on the CPU), f32, against the
    JAX eval logits (the head before the x4 rearrange): 1e-3. A grayscale
    batch is tiled to 3 channels on both sides. The CPU launches no kernel."""
    x, ref = _jax_logits(size, channels)
    before = k3.LAUNCHES["depthwise_conv2d"]
    with torch.no_grad():
        got = _nhwc(_port(channels, use_kernels=use_kernels).module(_nchw(x))["main"])
    assert got.shape == ref.shape == (2, size, size, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert k3.LAUNCHES["depthwise_conv2d"] == before


def test_kernel_path_calls_k3_in_every_mixffn(monkeypatch):
    """use_kernels=True runs K3 in all 32 MixFFN_skip convs of a forward (8
    encoder, 16 bridge, 8 decoder), each on channels-last [B, H, W, 4C]
    tokens, and agrees with the module path (grouped conv) within 1e-5 of
    the logits' largest magnitude; use_kernels=None on the CPU calls none."""
    calls = []
    real = k3.depthwise_conv2d
    monkeypatch.setattr(k3, "depthwise_conv2d",
                        lambda x, kern, bias: calls.append(tuple(x.shape)) or real(x, kern, bias))
    x, _ = _jax_logits(64, 3)
    with torch.no_grad():
        got = _port(use_kernels=True).module(_nchw(x))["main"]
        want = _port(use_kernels=False).module(_nchw(x))["main"]
    enc = [(2, 16, 16, 256)] * 2 + [(2, 8, 8, 512)] * 2 + [(2, 4, 4, 1280)] * 2 + \
        [(2, 2, 2, 2048)] * 2
    bridge = [(2, 16, 16, 256), (2, 8, 8, 256), (2, 4, 4, 256), (2, 2, 2, 256)] * 4
    dec = [(2, 2, 2, 2048)] * 2 + [(2, 4, 4, 1280)] * 2 + [(2, 8, 8, 512)] * 2 + \
        [(2, 16, 16, 256)] * 2
    assert calls == enc + bridge + dec
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())
    calls.clear()
    with torch.no_grad():
        create_model("missformer", device="cpu").module(_nchw(x))
    assert calls == []


def test_state_dict_round_trip():
    """The port's state_dict read back by the JAX package's converter gives
    the JAX variables, every leaf exact (strict load both ways)."""
    _, v, _ = _jax_model()
    sd = _port().module.state_dict()
    back = convert_state_dict("missformer", {k: t.numpy() for k, t in sd.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): np.asarray(a)
                         for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    want, got = flat(v), flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_registry_defaults():
    """missformer at the JAX registry's defaults: 512px, the two reference
    kwargs dropped, the SegFormer-B1 widths, 32 depthwise convs."""
    assert "missformer" in list_models()
    m, jax_spec = create_model("missformer", device="cpu", token_mlp_mode="mix_skip",
                               encoder_pretrained=True), JAX_REGISTRY["missformer"]
    assert (m.spec.requires_image_size, m.spec.default_image_size) == (
        jax_spec.requires_image_size, jax_spec.default_image_size) == (False, 512)
    assert m.image_size == 512
    mod = m.module
    assert [getattr(mod.backbone, f"norm{s}").normalized_shape[0] for s in (1, 2, 3, 4)] == [
        64, 128, 320, 512]
    assert mod.backbone.patch_embed1.proj.in_channels == 3
    assert create_model("missformer", device="cpu", in_channels=1).module.backbone \
        .patch_embed1.proj.in_channels == 3
    assert sum(isinstance(s, pmf.MixFFNSkip) for s in mod.modules()) == 32
    assert [c.kernel_size for c in mod.bridge.bridge_layer1.attn.scale_reduce.sr_convs] == [
        (8, 8), (4, 4), (2, 2)]


def test_patch_expand_rearrange_is_depth_to_space():
    """Each output pixel (y * p + i, x * p + j) takes channel slice (i * p + j)
    of its input pixel, as JAX's ``_patch_expand_rearrange``."""
    x = torch.arange(2 * 3 * 2 * 4 * 5, dtype=torch.float32).reshape(2, 3, 2, 4 * 5)
    y = pmf.patch_expand_rearrange(x, 2, 5)
    assert y.shape == (2, 6, 4, 5)
    for i in range(2):
        for j in range(2):
            sl = slice((i * 2 + j) * 5, (i * 2 + j + 1) * 5)
            assert torch.equal(y[:, i::2, j::2], x[..., sl])


def _adam_first_moment(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)).mu


def test_train_step_matches_jax():
    """One port step (module path, float32) from the JAX variables on a
    seeded uint8 batch of 2 at 32px against JAX's make_train_step: loss and
    Dice at 1e-5, every clipped first-step gradient (AdamW's first moment
    over 0.1) within 1e-2 of its tensor's largest entry plus 1e-5. The
    training forward (the head after the x4 rearrange) gives the eval
    forward's logits (the head before it) within 1e-5 of their largest."""
    m, v, _ = _jax_model()
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    masks = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.uint8)
    state = JaxTrainState.create(apply_fn=m.module.apply, params=v["params"], batch_stats={},
                                 tx=jax_make_optimizer(1e-4))
    state, metrics = jax_make_train_step(m)(state, jnp.asarray(images), jnp.asarray(masks))
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1,
                                   _adam_first_moment(state.opt_state))
    grads_ref = from_jax_variables("missformer", {"params": grads})

    model = _port()
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.module.train()
        train_order = model.module(x)["main"]
        model.module.eval()
        eval_order = model.module(x)["main"]
    np.testing.assert_allclose(train_order.numpy(), eval_order.numpy(), rtol=0,
                               atol=1e-5 * eval_order.abs().max().item())

    got = make_train_step(model)(create_train_state(model), _nchw(images), _nchw(masks))
    np.testing.assert_allclose(got["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["dice"].item(), float(metrics["dice"]), rtol=1e-5)
    for name, p in model.module.named_parameters():
        g_ref = grads_ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0,
                                   atol=1e-2 * np.abs(g_ref).max() + 1e-5, err_msg=f"grad {name}")
