"""The Switch-MoE FFN (``nn/moe.py``) and ``unext_moe`` in the port against the
JAX package (CPU).

``SwitchMoEMLP`` is held against JAX's at token counts that pad the last
group, let a group span two images and put experts over capacity, in
float32 and bfloat16: the outputs, each token's expert and the
load-balancing loss; and against an independent per-token numpy reference
(the JAX package's ``tests/test_moe.py`` reference, copied here). The whole
``unext_moe`` is held against JAX's eval logits and one JAX train step (loss
with the load-balancing term, every clipped gradient); the train step's
auxiliary loss is held under ``accum_steps`` 2, and the train CLI runs an
epoch of ``unext_moe``.
"""

import functools
import math
import os
import subprocess
import sys
import warnings

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from unet_zoo_tpu.models import _REGISTRY as JAX_REGISTRY
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.nn.moe import SwitchMoEMLP as JaxMoE
from unet_zoo_tpu.train.steps import TrainState as JaxTrainState
from unet_zoo_tpu.train.steps import make_optimizer as jax_make_optimizer
from unet_zoo_tpu.train.steps import make_train_step as jax_make_train_step
from unet_zoo_tpu_torch import create_model, list_models
from unet_zoo_tpu_torch.data.datasets import prepare_images
from unet_zoo_tpu_torch.nn.moe import SwitchMoEMLP, aux_loss_modules, pop_aux_losses
from unet_zoo_tpu_torch.ops.kernels import depthwise as k3
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.train.losses import bce_with_logits, multi_output_loss
from unet_zoo_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

CL = torch.channels_last
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE = 1e-6          # top-two router probabilities closer than this are reported


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))
                            ).contiguous(memory_format=CL)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _reference_moe(x_tokens, params, num_experts, cap, gelu):
    """Independent numpy per-token implementation of top-1 routing with
    capacity: token order queueing, over-capacity drop, gate scaling."""
    router = np.asarray(params["router_kernel"], np.float32)
    w1 = np.asarray(params["expert_fc1_kernel"], np.float32)
    b1 = np.asarray(params["expert_fc1_bias"], np.float32)
    w2 = np.asarray(params["expert_fc2_kernel"], np.float32)
    b2 = np.asarray(params["expert_fc2_bias"], np.float32)

    logits = x_tokens @ router
    e_logits = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e_logits / e_logits.sum(-1, keepdims=True)
    choice = probs.argmax(-1)
    gate = probs.max(-1)

    counts = np.zeros(num_experts, np.int64)
    y = np.zeros((x_tokens.shape[0], w2.shape[-1]), np.float32)
    for t in range(x_tokens.shape[0]):
        e = int(choice[t])
        counts[e] += 1
        if counts[e] > cap:
            continue  # dropped: residual carries the token
        h = gelu(x_tokens[t] @ w1[e] + b1[e])
        y[t] = gate[t] * (h @ w2[e] + b2[e])
    return y


def _gelu(v):
    return np.asarray(jax.nn.gelu(jnp.asarray(v), approximate=False))


# (input shape, experts, hidden, group size, capacity factor): [2, 12, 12]
# is 288 tokens, a group of 256 spanning both images and a last group of 32
# real and 224 padding tokens; [3, 5, 7] cuts groups of 32 across images
# with capacity 8 an expert; [1, 4, 4] is one group (JAX's own test)
MOE_CASES = [((2, 12, 12, 16), 4, 32, 256, 1.25), ((3, 5, 7, 16), 4, 24, 32, 1.0),
             ((1, 4, 4, 8), 2, 16, 16, 1.25)]


def _moe_case(shape, e, hid, group, cf, seed):
    """Seeded x of mean 0.5 and JAX params: the router scaled 3x and expert
    0's column shifted up by 0.3, so that tokens lean to expert 0 enough to
    overfill it; expert biases drawn off zero."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) + 0.5).astype(np.float32)
    m = JaxMoE(num_experts=e, hidden_dim=hid, capacity_factor=cf, group_size=group)
    p = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        m.init(jax.random.PRNGKey(seed), jnp.asarray(x))))["params"]
    p["router_kernel"] = 3.0 * p["router_kernel"]
    p["router_kernel"][:, 0] += 0.3
    for name in ("expert_fc1_bias", "expert_fc2_bias"):
        p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return x, p


def _groups(tokens, group):
    """Tokens [T, D] as JAX groups them: [Z, G, D] with zero padding, and T."""
    t = tokens.shape[0]
    g = min(group, t)
    pad = (-t) % g
    return np.concatenate([tokens, np.zeros((pad, tokens.shape[1]), tokens.dtype)]).reshape(
        -1, g, tokens.shape[1]), t


def _jax_routing(xs, router):
    """JAX's routing expression on grouped float32 tokens: probs and choice."""
    probs = jax.nn.softmax(jnp.einsum("zgd,de->zge", jnp.asarray(xs, jnp.float32),
                                      jnp.asarray(router)), axis=-1)
    return np.asarray(probs), np.asarray(jnp.argmax(probs, axis=-1))


def _port_moe(p, d, e, hid, group, cf, dtype):
    pm = SwitchMoEMLP(d, e, hid, dtype=dtype)
    pm.capacity_factor, pm.group_size = cf, group
    pm.load_state_dict({k: _t(v) for k, v in p.items()}, strict=True)
    return pm


def _check_ties(probs, t, where):
    """Reports real tokens whose top two probabilities lie within TIE; returns
    the mask of real tokens that are not so close."""
    top2 = np.sort(probs.reshape(-1, probs.shape[-1]), axis=-1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0])[:t]
    near = np.flatnonzero(gap < TIE)
    if near.size:
        warnings.warn(f"{where}: tokens {near.tolist()} have top-two router probabilities "
                      f"within {TIE} (gaps {gap[near].tolist()})")
    return gap >= TIE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,e,hid,group,cf", MOE_CASES)
def test_switch_moe_matches_jax(shape, e, hid, group, cf, dtype):
    """Outputs (float32: 1e-5; bfloat16: within 4 bf16 ulps of the output's
    largest magnitude, since XLA rounds its bf16 GELU in steps and may keep
    a matmul's output unrounded into its bias add where the port rounds each
    op once, as written: 2.4 ulps apart at most in these cases), each real
    token's expert and kept flag, the padding tokens (exact ties) on expert
    0, and the training load-balancing loss (1e-6) against JAX's module on
    the same weights and tokens."""
    x, p = _moe_case(shape, e, hid, group, cf, seed=len(shape) + shape[0] + e)
    d = shape[-1]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    jm = JaxMoE(num_experts=e, hidden_dim=hid, capacity_factor=cf, group_size=group, dtype=jdt)
    xj = jnp.asarray(x, jdt)
    want, mutated = jm.apply({"params": p}, xj, train=True, mutable=["aux_loss"])
    want = np.asarray(want.astype(jnp.float32))
    (aux_want,) = mutated["aux_loss"]["switch_load_balance"]

    pm = _port_moe(p, d, e, hid, group, cf, tdt).train()
    xt = _t(x).to(tdt)
    got = pm(xt)
    assert got.dtype == tdt and got.shape == x.shape
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -8 * np.abs(want).max())
    np.testing.assert_allclose(pm.aux_loss.item(), float(aux_want), rtol=0, atol=1e-6)

    # routing: JAX's choice on the same (compute-type) tokens, ties reported
    xs, t = _groups(xt.float().numpy().reshape(-1, d), group)
    probs, choice = _jax_routing(xs, p["router_kernel"])
    routing = pm.last_routing
    got_choice = routing["choice"].numpy().reshape(-1)
    clear = _check_ties(probs, t, f"{shape} {dtype}")
    np.testing.assert_array_equal(got_choice[:t][clear], choice.reshape(-1)[:t][clear])
    assert (got_choice[t:] == 0).all() and (choice.reshape(-1)[t:] == 0).all()
    # kept: the first capacity tokens of each expert's queue in a group
    onehot = np.eye(e)[choice]
    pos = (np.cumsum(onehot, axis=1) * onehot).sum(-1)
    np.testing.assert_array_equal(routing["kept"].numpy(), pos <= pm.capacity(xs.shape[1]))

    # eval: no auxiliary loss left
    pm.eval()
    pm(xt)
    assert pm.aux_loss is None and pop_aux_losses([pm]) == []


def test_switch_moe_cases_cover_padding_spanning_and_drops():
    """The cases above hold what they are for: a padded last group, a group
    spanning two images, and real tokens dropped at capacity in every case
    (float32 routing)."""
    for shape, e, hid, group, cf in MOE_CASES:
        x, p = _moe_case(shape, e, hid, group, cf, seed=len(shape) + shape[0] + e)
        pm = _port_moe(p, shape[-1], e, hid, group, cf, torch.float32).eval()
        with torch.no_grad():
            pm(_t(x))
        r = pm.last_routing
        t = r["tokens"]
        dropped = int((~r["kept"].reshape(-1)[:t]).sum())
        assert dropped > 0, shape
        per_image = shape[1] * shape[2]
        g = min(group, t)
        if shape[0] > 1:
            assert g > per_image or g % per_image, shape        # a group spans images
    padded = MOE_CASES[0]
    assert 2 * 12 * 12 % padded[3] == 32                        # 32 real tokens in the last group


@pytest.mark.parametrize("shape,e,hid,group,cf", MOE_CASES)
def test_switch_moe_matches_per_token_reference(shape, e, hid, group, cf):
    """float32 against the independent per-token reference, group by group
    (padding comes after every real token, so it moves no real token's
    place in a queue): 1e-5."""
    x, p = _moe_case(shape, e, hid, group, cf, seed=len(shape) + shape[0] + e)
    d = shape[-1]
    pm = _port_moe(p, d, e, hid, group, cf, torch.float32).eval()
    with torch.no_grad():
        got = pm(_t(x)).numpy().reshape(-1, d)
    tokens = x.reshape(-1, d)
    g = min(group, tokens.shape[0])
    cap = math.ceil(cf * g / e)
    ref = np.concatenate([_reference_moe(tokens[i:i + g], p, e, cap, _gelu)
                          for i in range(0, tokens.shape[0], g)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_switch_moe_capacity_one_keeps_first_token_per_expert():
    """Capacity 1 (JAX's capacity_factor 1e-9 case): only the first token
    routed to each expert has an output; every other one is exactly zero."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    m = JaxMoE(num_experts=2, hidden_dim=8, capacity_factor=1e-9, group_size=8)
    p = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        m.init(jax.random.PRNGKey(0), jnp.asarray(x))))["params"]
    pm = _port_moe(p, 4, 2, 8, 8, 1e-9, torch.float32).eval()
    with torch.no_grad():
        y = pm(_t(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(m.apply({"params": p}, jnp.asarray(x))), atol=1e-5)
    choice = (x @ p["router_kernel"]).argmax(-1)
    seen = set()
    for t in range(8):
        if choice[t] in seen:
            assert (y[t] == 0).all()
        else:
            assert np.abs(y[t]).max() > 0
        seen.add(choice[t])


# --- unext_moe ------------------------------------------------------------------------


def _off_init(rng, p):
    """Every LayerNorm off identity and every bias off zero (the MoE's
    expert biases too), in a JAX params dict."""
    for key, sub in p.items():
        if not isinstance(sub, dict):
            continue
        if set(sub) == {"scale", "bias"}:
            sub["scale"] = rng.uniform(0.5, 1.5, sub["scale"].shape).astype(np.float32)
        for name in ("bias", "expert_fc1_bias", "expert_fc2_bias"):
            if isinstance(sub.get(name), np.ndarray):
                sub[name] = (0.1 * rng.standard_normal(sub[name].shape)).astype(np.float32)
        _off_init(rng, sub)


@functools.lru_cache(maxsize=None)
def _jax_case():
    """JAX unext_moe at registry widths, its seed-0 variables with every
    LayerNorm and bias off init, a 64px input and its eval logits (XLA)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    m = jax_create_model("unext_moe")
    v = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(
        m.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    _off_init(rng, v["params"])
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False)["main"])
    return m, v, x, np.asarray(apply(v, jnp.asarray(x)))


def _port(v, **kw):
    m = create_model("unext_moe", device="cpu", **kw)
    m.module.load_state_dict(from_jax_variables("unext_moe", v), strict=True)
    return m


def test_registry_lists_unext_moe():
    assert "unext_moe" in list_models()
    m, jax_spec = create_model("unext_moe", device="cpu"), JAX_REGISTRY["unext_moe"]
    assert (m.spec.requires_image_size, m.spec.default_image_size) == (
        jax_spec.requires_image_size, jax_spec.default_image_size)
    mod = m.module
    # unext_s widths; block 1 of each stage has the 4-expert MoE FFN
    assert [getattr(mod, f"norm{s}").normalized_shape[0] for s in (1, 2, 3)] == [64, 128, 160]
    for s in (1, 2, 3):
        blocks = getattr(mod, f"block{s}")
        assert hasattr(blocks[0], "mlp") and not hasattr(blocks[0], "moe_mlp")
        moe = blocks[1].moe_mlp
        assert tuple(moe.expert_fc1_kernel.shape) == (4, blocks[1].norm2.normalized_shape[0],
                                                      4 * blocks[1].norm2.normalized_shape[0])
    assert create_model("unext_moe", device="cpu", moe_experts=2).module.block1[1].moe_mlp \
        .num_experts == 2


@pytest.mark.parametrize("use_kernels", [False, True])
def test_unext_moe_eval_logits_match_jax(use_kernels):
    """Module path and kernel path (the plain K3 on the CPU: 3 calls, one a
    stage), f32, 64px, against the JAX eval logits: 1e-3."""
    _, v, x, ref = _jax_case()
    calls = []
    real = k3.depthwise_conv2d
    k3.depthwise_conv2d = lambda *a: calls.append(tuple(a[0].shape)) or real(*a)
    try:
        with torch.no_grad():
            got = _nhwc(_port(v, use_kernels=use_kernels).module(_nchw(x))["main"])
    finally:
        k3.depthwise_conv2d = real
    assert got.shape == ref.shape == (2, 64, 64, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert calls == ([(2, 16, 16, 256), (2, 8, 8, 512), (2, 4, 4, 640)] if use_kernels else [])


def _adam_first_moment(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)).mu


@pytest.fixture(scope="module")
def jax_unext_moe_step():
    """One JAX make_train_step of unext_moe (drop_path_rate 0, 64px, B=2)
    from the variables of ``_jax_case`` on a seeded uint8 batch: the metrics,
    the load-balancing terms its forward sows, and the clipped gradient
    (AdamW's first moment after one step is 0.1 times it)."""
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    masks = (rng.random((2, 64, 64, 1)) > 0.5).astype(np.uint8)
    m, v, _, _ = _jax_case()
    state = JaxTrainState.create(apply_fn=m.module.apply, params=v["params"], batch_stats={},
                                 tx=jax_make_optimizer(1e-4))
    state, metrics = jax_make_train_step(m)(state, jnp.asarray(images), jnp.asarray(masks))
    normalised = prepare_images(_nchw(images)).numpy().transpose(0, 2, 3, 1)
    _, mutated = m.module.apply({"params": v["params"]}, jnp.asarray(normalised), train=True,
                                mutable=["aux_loss"])
    aux = float(sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(mutated["aux_loss"])))
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1,
                                   _adam_first_moment(state.opt_state))
    return (images, masks, v, {k: float(val) for k, val in metrics.items()}, aux,
            from_jax_variables("unext_moe", {"params": grads}))


def test_unext_moe_train_step_matches_jax(jax_unext_moe_step):
    """One port step (module path, float32) from JAX's variables and batch:
    the loss (with the load-balancing term of the three MoE blocks) and Dice
    at 1e-5, every clipped gradient within 1e-2 of its tensor's largest
    entry plus 1e-5, the router's included."""
    images, masks, v, metrics, aux, grads_ref = jax_unext_moe_step
    model = _port(v)
    # the port's load-balancing terms on the same batch, before the step
    model.module.train()
    with torch.no_grad():
        model.module(prepare_images(_nchw(images)))
    terms = pop_aux_losses(aux_loss_modules(model.module))
    assert len(terms) == 3
    np.testing.assert_allclose(sum(t.item() for t in terms), aux, rtol=1e-5)
    assert aux > 0.01 * 0.99                       # weight 0.01 times E sum f P >= 1 a block
    got = make_train_step(model)(create_train_state(model), _nchw(images), _nchw(masks))
    np.testing.assert_allclose(got["loss"].item(), metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dice"].item(), metrics["dice"], rtol=1e-5)
    names = []
    for name, p in model.module.named_parameters():
        g_ref = grads_ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=0,
                                   atol=1e-2 * np.abs(g_ref).max() + 1e-5, err_msg=f"grad {name}")
        names.append(name)
    assert "block1.1.moe_mlp.router_kernel" in names
    assert np.abs(grads_ref["block1.1.moe_mlp.router_kernel"].numpy()).max() > 0


def test_train_step_adds_aux_loss_per_microbatch():
    """accum_steps 2: the reported loss is the mean over the two microbatches
    of the segmentation loss plus that microbatch's load-balancing terms; with
    the terms' weight at 0 it is the segmentation loss alone."""
    rng = np.random.default_rng(14)
    images = torch.from_numpy(rng.integers(0, 256, (4, 3, 32, 32), dtype=np.uint8))
    masks = torch.from_numpy((rng.random((4, 1, 32, 32)) > 0.5).astype(np.uint8))
    readings = {}
    for weight in (0.01, 0.0):
        model = create_model("unext_moe", device="cpu", seed=3)
        moes = [m for m in model.module.modules() if isinstance(m, SwitchMoEMLP)]
        for moe in moes:
            moe.aux_loss_weight = weight
        model.module.train()
        want = []
        with torch.no_grad():
            for xb, mb in zip(images.chunk(2), masks.chunk(2)):
                out = model.module(prepare_images(xb))
                seg = multi_output_loss(out, mb.float(), model.loss_weight, bce_with_logits)
                aux = pop_aux_losses(moes)
                assert len(aux) == (3 if weight else 0)
                want.append((seg + sum(aux), seg))
        got = make_train_step(model, accum_steps=2)(create_train_state(model), images, masks)
        mean = sum(w[0] for w in want) / 2
        np.testing.assert_allclose(got["loss"].item(), mean.item(), rtol=1e-6)
        readings[weight] = (got["loss"].item(), (sum(w[1] for w in want) / 2).item())
        assert all(m.aux_loss is None for m in moes)   # collected and cleared
    assert readings[0.01][0] > readings[0.01][1] + 0.02    # three terms of at least 0.01
    np.testing.assert_allclose(readings[0.0][0], readings[0.0][1], rtol=1e-6)


def test_eval_collects_no_aux_loss():
    from unet_zoo_tpu_torch.train import make_eval_step

    model = create_model("unext_moe", device="cpu")
    images = torch.zeros(2, 3, 32, 32, dtype=torch.uint8)
    masks = torch.zeros(2, 1, 32, 32, dtype=torch.uint8)
    out = make_eval_step(model)(None, images, masks)
    assert torch.isfinite(out["loss"])
    mods = aux_loss_modules(model.module)
    assert len(mods) == 3 and pop_aux_losses(mods) == []


def test_train_cli_runs_unext_moe(tmp_path):
    """cli.train runs one epoch of unext_moe on a synthetic 32px PNG set on
    the CPU and saves the MoE parameters in its checkpoints."""
    from PIL import Image

    from unet_zoo_tpu_torch.utils.checkpoint import load_checkpoint

    data = tmp_path / "data"
    rng = np.random.default_rng(0)
    for split in ("train", "valid", "test"):
        for sub in ("images", "masks"):
            (data / split / sub).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                data / split / "images" / f"{i:03d}.png")
            mk = np.zeros((32, 32), np.uint8)
            mk[8:24, 10:30] = 255
            Image.fromarray(mk).save(data / split / "masks" / f"{i:03d}.png")
    cfg = {
        "general": {"project_name": "t", "working_dir": str(tmp_path / "runs")},
        "data": {"dataset_dir": str(data), "num_workers": 0, "image_size": 32,
                 "augment": False},
        "training": {"epochs": 1, "batch_size": 2, "learning_rate": 1e-3,
                     "early_stopping_patience": 3, "lr_scheduler_patience": 1,
                     "lr_scheduler_factor": 0.5, "min_lr": 1e-6, "num_classes": 1},
        "models": {"names": ["unext_moe"]},
        "run_timestamp": "fixed",
    }
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "unet_zoo_tpu_torch.cli.train", "--config",
                        str(tmp_path / "train.yaml"), "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    run = tmp_path / "runs" / "overall_runs_fixed" / "unext_moe"
    assert "unext_moe - Epoch 1/1" in (run / "logs" / "training_log.txt").read_text()
    saved = load_checkpoint(str(run / "checkpoints" / "unext_moe_last"))
    keys = set(saved["variables"])
    assert {f"block{s}.1.moe_mlp.router_kernel" for s in (1, 2, 3)} <= keys
