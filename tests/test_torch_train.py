"""The port's training pieces against the JAX package (CPU): criteria,
metrics, batch preparation, the clip + AdamW optimizer, the train step with
gradient accumulation, the eval step, and train-mode BatchNorm with Flax's
biased running variance."""

import dataclasses

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu.data.datasets import prepare_images as jax_prepare_images
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.nn import BatchNorm as JaxBatchNorm
from unet_zoo_tpu.train import losses as jax_losses
from unet_zoo_tpu.train import metrics as jax_metrics
from unet_zoo_tpu.train import steps as jax_steps
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.data import prepare_images, prepare_masks
from unet_zoo_tpu_torch.models import medt_net, mmunet
from unet_zoo_tpu_torch.nn import batch_norm, blocks
from unet_zoo_tpu_torch.train import (
    CRITERIA,
    boundary_f1,
    create_train_state,
    dice_coefficient,
    get_criterion,
    get_lr,
    iou_score,
    make_eval_step,
    make_optimizer,
    make_train_step,
    multi_output_loss,
    set_lr,
    variables_of,
)

torch.set_num_threads(1)

CL = torch.channels_last


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


# --- criteria and metrics ---------------------------------------------------------


def _logits_and_masks(seed, shape=(2, 12, 10, 1)):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    masks = (rng.random(shape) > 0.6).astype(np.float32)
    return logits, masks


@pytest.mark.parametrize("name,kwargs", [
    ("bce", {}), ("bce_with_logits", {}), ("dice", {}), ("dice", {"smooth": 0.5}),
    ("bce_dice", {}), ("combo", {"bce_weight": 0.3, "dice_weight": 0.7}), ("focal", {}),
    ("focal", {"gamma": 1.5, "alpha": None}), ("tversky", {}),
    ("tversky", {"alpha": 0.5, "beta": 0.5}),
])
def test_criteria_match_jax(name, kwargs):
    """float32 on both sides: 1e-6 relative."""
    logits, masks = _logits_and_masks(0)
    want = jax_losses.get_criterion(name, **kwargs)(jnp.asarray(logits), jnp.asarray(masks))
    got = get_criterion(name, **kwargs)(_nchw(logits), _nchw(masks))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_get_criterion_rejects_unknown_names_and_bce_kwargs():
    assert set(CRITERIA) == set(jax_losses.CRITERIA)
    with pytest.raises(ValueError, match="Unknown loss"):
        get_criterion("hinge")
    with pytest.raises(ValueError, match="no loss_kwargs"):
        get_criterion("bce", smooth=1.0)


@pytest.mark.parametrize("criterion", ["bce", "bce_dice"])
def test_multi_output_loss_with_side_output_matches_jax(criterion):
    """'main', a half-size 'side1' (the mask resized to it, bilinear,
    align_corners=False) and a non-logit key that must be skipped: 1e-6."""
    logits, masks = _logits_and_masks(1, (2, 16, 12, 1))
    side, _ = _logits_and_masks(2, (2, 8, 6, 1))
    weight = lambda key: 1.0 if key == "main" else 0.4
    outs = {"main": logits, "side1": side, "attn_weights": side * 100}
    want = jax_losses.multi_output_loss({k: jnp.asarray(v) for k, v in outs.items()},
                                        jnp.asarray(masks), weight,
                                        jax_losses.get_criterion(criterion))
    got = multi_output_loss({k: _nchw(v) for k, v in outs.items()}, _nchw(masks), weight,
                            get_criterion(criterion))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_dice_and_iou_match_jax(seed):
    logits, masks = _logits_and_masks(seed)
    for fn, jfn in ((dice_coefficient, jax_metrics.dice_coefficient),
                    (iou_score, jax_metrics.iou_score)):
        got = fn(_nchw(logits), _nchw(masks))
        assert got.dim() == 0
        np.testing.assert_allclose(got.item(), float(jfn(jnp.asarray(logits),
                                                         jnp.asarray(masks))), rtol=1e-6)
        # empty prediction and empty target: 1.0, as the reference
        assert fn(torch.full((1, 1, 4, 4), -5.0), torch.zeros(1, 1, 4, 4)).item() == 1.0


def test_boundary_f1_matches_jax():
    rng = np.random.default_rng(3)
    a = np.zeros((24, 24), bool)
    a[4:15, 5:17] = True
    b = np.roll(a, 2, axis=1) | (rng.random((24, 24)) > 0.97)
    for p, t in ((a, b), (b, a), (a, a), (a[None, ..., None], b)):
        assert boundary_f1(p, t) == jax_metrics.boundary_f1(p, t)
    assert boundary_f1(np.zeros((8, 8)), np.zeros((8, 8))) == 1.0
    assert boundary_f1(a, np.zeros_like(a)) == 0.0


def test_prepare_images_and_masks_match_jax():
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    got = prepare_images(_nchw(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jax_prepare_images(jnp.asarray(images))),
                               rtol=1e-6, atol=1e-6)
    x = torch.randn(1, 3, 2, 2)
    assert prepare_images(x) is x
    masks = torch.from_numpy((rng.random((1, 1, 4, 4)) > 0.5).astype(np.uint8))
    assert torch.equal(prepare_masks(masks), masks.float())


# --- the optimizer ------------------------------------------------------------------


@pytest.mark.parametrize("norm", [0.5, 3.0])
def test_clip_adamw_matches_optax(norm):
    """Two updates of clip-by-global-norm(1.0) + AdamW(wd 1e-5) against the
    JAX package's optimizer (optax), the second after a learning-rate change,
    on a tree with a parameter the loss does not use (no gradient in torch,
    a zero one in JAX: both decay it): float32, within two ulps (2.5e-7) of
    parameters of order 1 moved by about 1e-3."""
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5),
              "z": rng.standard_normal(2)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    grads = []
    for _ in range(2):
        g = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5)}
        total = np.sqrt(sum((v ** 2).sum() for v in g.values()))
        grads.append({k: (v * norm / total).astype(np.float32) for k, v in g.items()})

    tx = jax_steps.make_optimizer(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), 1e-3)
    for step, g in enumerate(grads):
        if step == 1:
            opt_state.hyperparams["learning_rate"] = jnp.asarray(5e-4, jnp.float32)
            opt.lr = 5e-4
        jg = {k: jnp.asarray(g.get(k, np.zeros_like(params[k]))) for k in params}
        updates, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=2.5e-7, err_msg=f"step {step} {k}")
    assert tp["z"].grad is not None and not tp["z"].grad.any()
    assert opt.adamw.state[tp["z"]]["step"].item() == 2    # updated from the first step


# --- the train and eval steps ---------------------------------------------------


class _JaxTiny(fnn.Module):
    """conv3x3 -> BN -> ReLU -> 1x1 heads: full size 'main', half size 'side1'."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = fnn.Conv(4, (3, 3), padding=((1, 1), (1, 1)), use_bias=False, name="conv")(x)
        h = fnn.relu(JaxBatchNorm(train, name="bn")(h))
        return {"main": fnn.Conv(1, (1, 1), name="head")(h),
                "side1": fnn.Conv(1, (1, 1), name="side")(h[:, ::2, ::2])}


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(4)
        self.head = nn.Conv2d(4, 1, 1)
        self.side = nn.Conv2d(4, 1, 1)

    def forward(self, x):
        h = torch.relu(batch_norm(self.conv(x), self.bn))
        return {"main": self.head(h), "side1": self.side(h[:, :, ::2, ::2])}


def _tiny_state_dict(v):
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    p, s = v["params"], v["batch_stats"]
    conv_w = lambda k: t(np.transpose(np.asarray(k), (3, 2, 0, 1)))
    return {"conv.weight": conv_w(p["conv"]["kernel"]), "bn.weight": t(p["bn"]["scale"]),
            "bn.bias": t(p["bn"]["bias"]), "bn.running_mean": t(s["bn"]["mean"]),
            "bn.running_var": t(s["bn"]["var"]),
            "bn.num_batches_tracked": torch.tensor(0),
            "head.weight": conv_w(p["head"]["kernel"]), "head.bias": t(p["head"]["bias"]),
            "side.weight": conv_w(p["side"]["kernel"]), "side.bias": t(p["side"]["bias"])}


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny model in both frameworks (the 'unet' registry entry's loss
    weights: main 1.0, side 0.5) with the same initial weights, and a batch."""
    jm = dataclasses.replace(jax_create_model("unet"), module=_JaxTiny())
    pm = dataclasses.replace(create_model("unet", device="cpu"), module=_Tiny())
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (4, 12, 12, 3), dtype=np.uint8)
    masks = (rng.random((4, 12, 12, 1)) > 0.5).astype(np.uint8)
    return jm, pm, images, masks


def _off_zero(state):
    """The heads' biases off zero: with them at zero, pixels whose features
    the ReLU zeroes give exactly zero logits, where the JAX BCE's autodiff
    takes a subgradient (see ``unet_zoo_tpu_torch/train/losses.py``)."""
    params = flax.core.unfreeze(state.params)
    for name, value in (("head", 0.3), ("side", -0.2)):
        params[name]["bias"] = jnp.full_like(params[name]["bias"], value)
    return state.replace(params=params)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(tiny_models, accum_steps):
    """Two steps with ``accum_steps`` 1 and 2 (two microbatches: gradients
    summed and averaged, BN statistics updated per microbatch, loss and
    Dice the microbatch means) against the JAX make_train_step: float32,
    loss and Dice at 1e-6, parameters and batch statistics at 1e-6."""
    jm, pm, images, masks = tiny_models
    jstate = _off_zero(jax_steps.create_train_state(jm, jax.random.PRNGKey(0),
                                                    jnp.zeros((4, 12, 12, 3)), learning_rate=1e-3))
    pm.module.load_state_dict(_tiny_state_dict({"params": jstate.params,
                                                "batch_stats": jstate.batch_stats}))
    state = create_train_state(pm, learning_rate=1e-3)
    assert get_lr(state) == pytest.approx(1e-3) == jax_steps.get_lr(jstate)
    jstep = jax_steps.make_train_step(jm, accum_steps=accum_steps)
    step = make_train_step(pm, accum_steps=accum_steps)
    for _ in range(2):
        jstate, want = jstep(jstate, jnp.asarray(images), jnp.asarray(masks))
        got = step(state, _nchw(images), _nchw(masks))
        for key in ("loss", "dice"):
            np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-6)
    sd = pm.module.state_dict()
    ref = _tiny_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    for name, t in ref.items():
        if name.endswith("num_batches_tracked"):
            assert sd[name].item() == 2 * accum_steps
            continue
        np.testing.assert_allclose(sd[name].numpy(), t.numpy(), rtol=0, atol=1e-6, err_msg=name)
    set_lr(state, 2e-4)
    assert get_lr(state) == 2e-4
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(pm, accum_steps=3)(state, _nchw(images), _nchw(masks))


def test_eval_step_matches_jax(tiny_models):
    """Eval (running statistics) on the same variables: loss, Dice and the
    main logits at 1e-6; the module's mode is left as it was."""
    jm, pm, images, masks = tiny_models
    jstate = _off_zero(jax_steps.create_train_state(jm, jax.random.PRNGKey(1),
                                                    jnp.zeros((4, 12, 12, 3))))
    state = create_train_state(pm)
    variables = _tiny_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    want = jax_steps.make_eval_step(jm)(jax_steps.variables_of(jstate), jnp.asarray(images),
                                        jnp.asarray(masks))
    pm.module.train()
    got = make_eval_step(pm)(variables, _nchw(images), _nchw(masks))
    assert pm.module.training
    for key in ("loss", "dice"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-6)
    np.testing.assert_allclose(got["main"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(want["main"]), rtol=0, atol=1e-6)
    assert set(variables_of(state)) == set(variables)


@pytest.mark.parametrize("flag", ["remat"])
def test_train_step_options_not_ported_raise(tiny_models, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(tiny_models[1], **{flag: True})


# --- train-mode BatchNorm -------------------------------------------------------


def test_batch_norm_running_var_is_biased_as_flax():
    """[2, 4, 8, 8] after one train step: output, running mean and running
    variance against Flax's BatchNorm (biased variance, decay 0.9) at 1e-6;
    torch's own update (the unbiased variance) differs by more."""
    x = np.random.default_rng(8).standard_normal((2, 4, 8, 8)).astype(np.float32)
    bn = nn.BatchNorm2d(4).train()
    y = batch_norm(torch.from_numpy(x), bn)
    m = JaxBatchNorm(True)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    yj, mut = m.apply(m.init(jax.random.PRNGKey(0), xj), xj, mutable=["batch_stats"])
    stats = mut["batch_stats"]
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(yj),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=0,
                               atol=1e-6)
    assert bn.num_batches_tracked.item() == 1
    unbiased = nn.BatchNorm2d(4).train()
    unbiased(torch.from_numpy(x))
    assert np.abs(unbiased.running_var.numpy() - np.asarray(stats["var"])).max() > 1e-4


def _eval_batch_norm(x, bn):
    """Eval BatchNorm as ``F.batch_norm`` applies the running statistics,
    the helper's eval branch before train mode followed Flax."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight.float(), bn.bias.float(),
                        False, bn.momentum, bn.eps)


@pytest.mark.parametrize("name,kwargs", [("unet", {}), ("mmunet", {"base_channels": 16}),
                                         ("gated", {"image_size": 32})])
def test_eval_paths_unchanged_by_batch_norm_repair(monkeypatch, name, kwargs):
    """Eval forwards of unet, mmunet and gated (module paths and kernel
    paths, BN statistics off identity) equal, bit for bit, the forwards with
    plain ``F.batch_norm`` on the running statistics, and change no buffer."""
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(9))
    for use_kernels in (False, True):
        model = create_model(name, device="cpu", use_kernels=use_kernels, **kwargs)
        g = torch.Generator().manual_seed(10)
        for m in model.module.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.1, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
        before = {k: t.clone() for k, t in model.module.state_dict().items()}
        with torch.no_grad():
            got = model.module(x)["main"]
            for module in (blocks, mmunet, medt_net):
                monkeypatch.setattr(module, "batch_norm", _eval_batch_norm)
            want = model.module(x)["main"]
            monkeypatch.undo()
        assert torch.equal(got, want), (name, use_kernels)
        for k, t in model.module.state_dict().items():
            assert torch.equal(t, before[k]), k
