"""Data-parallel and FSDP steps of the port over gloo (CPU), against the port
in one process and against the JAX package's steps on a 2-device mesh.

The ranks are child processes (``python -c``) that import only torch and the
port: each joins a gloo group through a ``file://`` store in ``tmp_path``,
runs the scenarios of one launch on its rows of the same seeded global
batch and writes what it read to ``tmp_path``; the tests compare it here.
Each launch runs once for the file (``launch``), and the JAX side runs in
this process on ``create_mesh(jax.devices()[:2])`` of conftest's 8 CPU
devices. Held:

* ``unet`` (32px, B=4) DP step against the port's one-process step: loss and
  Dice within 1e-5, every clipped gradient within 1e-2 of its tensor's
  largest entry plus 1e-5 (the ``gated`` scheme), running statistics 1e-5;
  against JAX's 2-device GSPMD step: loss within 1e-4
  (``tests/test_distributed.py:49``);
* the per-replica step against JAX's ``make_train_step_shard_map`` on the
  same shards: loss within 1e-4, running statistics 1e-5;
* fsdp against DP: the same loss, Dice, gradients and statistics, and the
  same update where the gradient is resolved; each rank's parameter and
  moment bytes at most 1/N of the whole plus padding; its checkpoint,
  written by rank 0 alone, restores bit for bit in one process;
* a narrow ``resunet`` DP step with two microbatches and flips on the
  device against one process (each rank's share of each microbatch, the
  flips drawn for the global batch);
* ``gated`` (layers (1, 1, 1, 1)) DP step, K7's plain version on every
  positional axis pass with its moments and S summed over the ranks,
  against the port in one process and JAX's 2-device step (XLA path);
* ``vnet`` served by a sharded predictor (its BatchNorm takes the batch's
  statistics in eval too) against one process; ``unext_moe``'s load-balancing
  term under DP against one process, and a routing group that would span two
  ranks raising.
"""

import contextlib
import dataclasses
import functools
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.data.datasets import prepare_images, prepare_masks
from unet_zoo_tpu_torch.models.medt_net import ResAxialAttentionUNet
from unet_zoo_tpu_torch.ops.kernels import axial_train as k7
from unet_zoo_tpu_torch.parallel import (
    create_mesh,
    fsdp_sharding_for,
    initialize_distributed,
    is_primary,
    make_global_batch,
    process_batch_slice,
    replicate_state,
    shard_batch,
    shard_state_fsdp,
)
from unet_zoo_tpu_torch.parallel.fsdp import sharded_bytes
from unet_zoo_tpu_torch.parallel.multihost import batch_rows, fully_replicate_to_host
from unet_zoo_tpu_torch.parallel.shard_map_step import make_train_step_shard_map
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.utils import checkpoint
from unet_zoo_tpu_torch.utils.serving import make_predictor

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SIZE, BATCH, LR = 32, 4, 1e-3
GATED_LAYERS = (1, 1, 1, 1)


# --- the launcher ----------------------------------------------------------------


class Ranks:
    """``module.child(scenario, rank, world, tmp)`` running in ``world`` child
    processes (gloo over ``tmp``'s file store), started at once; ``result``
    waits for them and returns each rank's result."""

    def __init__(self, module: str, scenario: str, world: int, tmp: str):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]), OMP_NUM_THREADS="1")
        env.pop("WORLD_SIZE", None)
        self.scenario, self.world, self.tmp = scenario, world, tmp
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", f"import {module} as m; m.child({scenario!r}, {r}, {world}, "
                                   f"{tmp!r})"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self._result = None

    def result(self, timeout: int = 300) -> list:
        if self._result is None:
            outs = [p.communicate(timeout=timeout)[0] for p in self.procs]
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"rank {r} of {self.scenario}:\n{out[-4000:]}"
            self._result = [torch.load(os.path.join(self.tmp, f"{self.scenario}_{r}.pt"),
                                       weights_only=False) for r in range(self.world)]
        return self._result


def child(scenario: str, rank: int, world: int, tmp: str) -> None:
    """A rank: join the group, run ``scenario`` and save what it returns."""
    torch.set_num_threads(1)
    assert "jax" not in sys.modules
    assert initialize_distributed(f"file://{os.path.join(tmp, scenario + '_store')}",
                                  world_size=world, rank=rank, device="cpu")
    try:
        out = SCENARIOS[scenario](tmp)
        assert "jax" not in sys.modules and "unet_zoo_tpu" not in sys.modules
        torch.save(out, os.path.join(tmp, f"{scenario}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --- inputs shared by both sides ----------------------------------------------------


def batch(seed: int, size: int = SIZE, b: int = BATCH):
    """A seeded global batch: uint8 images [B, 3, H, W] and {0, 1} masks."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 3, size, size), dtype=np.uint8)
    masks = (rng.random((b, 1, size, size)) > 0.5).astype(np.uint8)
    return torch.from_numpy(images), torch.from_numpy(masks)


def unet_model(tmp, f64=False):
    model = create_model("unet", device="cpu")
    model.module.load_state_dict(torch.load(os.path.join(tmp, "unet_sd.pt")), strict=True)
    if f64:
        model.module.double()
        for m in model.module.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float64
    return model


@contextlib.contextmanager
def float64_batch_norm():
    """Within, ``F.batch_norm`` takes its affine in its input's type (the
    port's ``batch_norm`` hands it a float32 one, which a float64 input
    refuses), as ``test_torch_core_members.float64_batch_norm``."""
    bn = F.batch_norm
    cast = lambda t, x: None if t is None else t.to(x.dtype)
    F.batch_norm = lambda x, mean, var, w, b, *args: bn(x, mean, var, cast(w, x), cast(b, x),
                                                        *args)
    try:
        yield
    finally:
        F.batch_norm = bn


def gated_model(tmp):
    model = create_model("gated", device="cpu", image_size=SIZE)
    model = dataclasses.replace(model, module=ResAxialAttentionUNet(
        mode="gated", layers=GATED_LAYERS, img_size=SIZE, use_kernels=True))
    model.module.load_state_dict(torch.load(os.path.join(tmp, "gated_sd.pt")), strict=True)
    return model


def step_reading(model, state, metrics, params=True):
    """What a step leaves: loss, Dice, the clipped gradients (whole), the
    running statistics and the updated parameters (whole; a rank but the
    first keeps a CRC of each)."""
    full = fully_replicate_to_host(dict(model.module.named_parameters()))
    grads = fully_replicate_to_host({n: p.grad for n, p in model.module.named_parameters()})
    out = {"loss": metrics["loss"].item(), "dice": metrics["dice"].item(), "grads": grads,
           "stats": {n: b.clone() for n, b in model.module.state_dict().items()
                     if "running" in n},
           "crc": {n: zlib.crc32(t.numpy().tobytes()) for n, t in full.items()},
           "step": state.step}
    if params and not (dist.is_initialized() and dist.get_rank()):
        out["params"] = full
    return out


def one_step(model, images, masks, mesh=None, params=True):
    state = create_train_state(model, learning_rate=LR)
    if mesh is not None:
        replicate_state(mesh, state)
        images, masks = shard_batch(mesh, images, masks)
    metrics = make_train_step(model, mesh=mesh)(state, images, masks)
    return step_reading(model, state, metrics, params)


# --- the scenarios (run in the ranks) ------------------------------------------------


def _dp(tmp):
    mesh = create_mesh(device_type="cpu")
    images, masks = batch(0)
    out = {"runtime": dict(
        slice=process_batch_slice(BATCH), primary=is_primary(),
        global_batch=make_global_batch(mesh, images[:2]).shape,
        layouts={n: tuple(type(pl).__name__ for pl in layout.placements)
                 for n, layout in fsdp_sharding_for(mesh, unet_model(tmp).module).items()})}
    out["unet_dp"] = one_step(unet_model(tmp), images, masks, mesh)
    with float64_batch_norm():
        out["unet64_dp"] = one_step(unet_model(tmp, f64=True), images, masks, mesh, params=False)

    # fsdp: the same step with the parameters and moments sharded
    model = unet_model(tmp)
    state = shard_state_fsdp(mesh, create_train_state(model, learning_rate=LR))
    local = shard_batch(mesh, images, masks)
    metrics = make_train_step(model, mesh=mesh)(state, *local)
    out["unet_fsdp"] = step_reading(model, state, metrics)
    out["fsdp_bytes"] = sharded_bytes(state)
    out["fsdp_rows"] = {n: tuple(p.to_local().shape) for n, p in model.module.named_parameters()}
    saves = []
    save = torch.save
    checkpoint.torch.save = lambda obj, f: (saves.append(f), save(obj, f))
    try:
        checkpoint.save_checkpoint(os.path.join(tmp, "fsdp_ckpt"), {
            "variables": model.module.state_dict(), "opt_state": state.optimizer.adamw.state_dict(),
            "step": state.step, "meta": {"epoch": 1}})
    finally:
        checkpoint.torch.save = save
    out["saves"] = len(saves)

    # the per-replica step (nn.DataParallel's semantics)
    model = unet_model(tmp)
    state = replicate_state(mesh, create_train_state(model, learning_rate=LR))
    metrics = make_train_step_shard_map(model, mesh)(state, *local)
    out["unet_shard_map"] = step_reading(model, state, metrics)

    # gated: K7's plain version with its moments and S over the ranks
    images, masks = batch(7)
    out["gated_dp"] = one_step(gated_model(tmp), images, masks, mesh)

    # two microbatches and on-device flips: each rank holds its share of each
    # microbatch (batch_rows) and takes its rows' flips of the global draws
    out["resunet_accum_dp"] = accum_step(mesh)

    # vnet served over the mesh; unext_moe's load-balancing term
    vnet = create_model("vnet", device="cpu", seed=3)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (BATCH, 3, SIZE, SIZE)).astype(np.float32))
    out["vnet"] = make_predictor(vnet, None, "logits", cast_bf16=False, mesh=mesh)(x)
    out["moe"] = moe_terms(mesh)
    return out


def accum_step(mesh=None):
    """A narrow ``resunet`` step with ``grad_accum_steps`` 2 and flips on the
    device, on a seeded global batch of 8."""
    model = create_model("resunet", device="cpu", seed=0, filters=(8, 16, 16, 16))
    state = create_train_state(model, learning_rate=LR)
    images, masks = batch(3, b=8)
    if mesh is not None:
        replicate_state(mesh, state)
        images, masks = shard_batch(mesh, images, masks, microbatches=2)
    step = make_train_step(model, augment=True, accum_steps=2, mesh=mesh)
    return step_reading(model, state, step(state, images, masks))


def moe_terms(mesh=None):
    """The MoE blocks' load-balancing terms of one train-mode forward of
    ``unext_moe`` (groups of 4 tokens, so that each rank's tokens are whole
    groups), and whether groups of 256 (spanning two ranks) raise."""
    from unet_zoo_tpu_torch.nn.moe import aux_loss_modules, pop_aux_losses
    from unet_zoo_tpu_torch.parallel import global_batch_statistics

    model = create_model("unext_moe", device="cpu", seed=2, image_size=SIZE)
    moe = aux_loss_modules(model.module)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        0.5, 1.0, (BATCH, 3, SIZE, SIZE)).astype(np.float32))
    if mesh is not None:
        x = shard_batch(mesh, x)
    group = None if mesh is None else mesh.get_group("data")
    model.module.train()
    for m in moe:
        m.group_size = 4
    with global_batch_statistics(group):
        model.module(x)
    terms = torch.stack([t.detach() for t in pop_aux_losses(moe)])
    if group is not None:
        dist.all_reduce(terms, group=group)
        terms /= dist.get_world_size(group)
    spans = None
    if group is not None:
        for m in moe:
            m.group_size = 256
        try:
            with global_batch_statistics(group):
                model.module(x)
            spans = "ran"
        except ValueError as e:
            spans = str(e)
    return {"terms": terms, "spans": spans}


SCENARIOS = {"dp": _dp}


# --- this process: the launches, the port in one process, JAX ---------------------------


@functools.lru_cache(maxsize=None)
def shared_dir():
    """A directory for this process's launches, removed at its exit."""
    import atexit
    import shutil
    import tempfile

    path = tempfile.mkdtemp(prefix="torch_parallel_")
    atexit.register(shutil.rmtree, path, True)
    return path


@functools.lru_cache(maxsize=None)
def jax_side():
    """The JAX variables of ``unet`` and of ``gated`` (layers (1, 1, 1, 1))
    as the port's state_dicts, written where the ranks read them."""
    import jax

    import test_torch_core_members as core
    from unet_zoo_tpu.models import create_model as jax_create_model
    from unet_zoo_tpu.models.medt_net import ResAxialAttentionUNet as JaxGated
    from unet_zoo_tpu.train.steps import create_train_state as jax_create_train_state
    from unet_zoo_tpu_torch.utils.convert import from_jax_variables

    tmp = shared_dir()
    m, v = core.jax_variables("unet", SIZE)
    torch.save(from_jax_variables("unet", v), os.path.join(tmp, "unet_sd.pt"))
    g = jax_create_model("gated", image_size=SIZE, use_pallas=False)
    g = dataclasses.replace(g, module=JaxGated(mode="gated", layers=GATED_LAYERS, img_size=SIZE,
                                               use_pallas=False))
    gs = jax_create_train_state(g, jax.random.PRNGKey(0), jax.numpy.zeros((1, SIZE, SIZE, 3)))
    gv = jax.tree_util.tree_map(np.asarray, {"params": gs.params, "batch_stats": gs.batch_stats})
    torch.save(from_jax_variables("gated", gv), os.path.join(tmp, "gated_sd.pt"))
    RANKS["dp"] = Ranks("test_torch_parallel", "dp", 2, tmp)   # runs while JAX compiles here
    return {"unet": (m, v), "gated": (g, gv)}


RANKS = {}


def launch(scenario: str = "dp") -> list:
    jax_side()
    return RANKS[scenario].result()


@functools.lru_cache(maxsize=None)
def single(name: str):
    """The port's one-process step of ``name`` on the same global batch."""
    jax_side()
    tmp = shared_dir()
    if name == "unet64":
        with float64_batch_norm():
            return one_step(unet_model(tmp, f64=True), *batch(0), params=False)
    if name == "unet":
        return one_step(unet_model(tmp), *batch(0))
    if name == "resunet":
        return accum_step()
    return one_step(gated_model(tmp), *batch(7))


def jax_two_device_step(name: str, shard_map: bool = False):
    """JAX's step of ``name`` on a 2-device mesh from the same variables and
    batch: metrics and the batch statistics after it as a port state_dict."""
    import jax
    import jax.numpy as jnp

    from unet_zoo_tpu.parallel import create_mesh as jax_create_mesh
    from unet_zoo_tpu.parallel import replicate_state as jax_replicate
    from unet_zoo_tpu.parallel import shard_batch as jax_shard_batch
    from unet_zoo_tpu.parallel.shard_map_step import make_train_step_shard_map as jax_sm
    from unet_zoo_tpu.train.steps import TrainState, make_optimizer, make_train_step as jax_step
    from unet_zoo_tpu_torch.utils.convert import from_jax_variables

    m, v = jax_side()[name]
    images, masks = batch(0 if name == "unet" else 7)
    mesh = jax_create_mesh(jax.devices()[:2])
    state = TrainState.create(apply_fn=m.module.apply, params=v["params"],
                              batch_stats=v["batch_stats"], tx=make_optimizer(LR))
    state = jax_replicate(mesh, state)
    if shard_map:   # JAX's per-replica step takes prepared images and float masks
        images, masks = prepare_images(images), prepare_masks(masks)
    im, mk = jax_shard_batch(mesh, images.numpy().transpose(0, 2, 3, 1),
                             masks.numpy().transpose(0, 2, 3, 1))
    step = jax_sm(m, mesh) if shard_map else jax_step(m)
    state, metrics = step(state, im, mk)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    sd = from_jax_variables(name, {"params": jax.tree_util.tree_map(np.asarray, state.params),
                                   "batch_stats": stats})
    return {k: float(x) for k, x in metrics.items()}, {n: t for n, t in sd.items()
                                                       if "running" in n}


def rank_result(key: str):
    """``key`` of the 2-rank launch's result, the same on both ranks."""
    r0, r1 = (r[key] for r in launch())
    return r0, r1


def assert_same_step(got, ref, loss_tol=1e-5, check_grads=True):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=loss_tol)
    np.testing.assert_allclose(got["dice"], ref["dice"], rtol=loss_tol, atol=1e-7)
    if check_grads:
        for name, g in ref["grads"].items():
            scale = g.abs().max().item()
            np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=0,
                                       atol=1e-2 * scale + 1e-5, err_msg=name)
    for name, s in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][name].numpy(), s.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


# --- the tests --------------------------------------------------------------------------


def test_batch_rows_lay_microbatches_over_the_ranks():
    """Rank r holds rows [r B/N, (r+1) B/N) of one microbatch, and the r-th
    share of each of k microbatches (JAX's microbatch i is rows
    [i B/k, (i+1) B/k)); a batch that does not divide raises."""
    assert batch_rows(8, 1, 1, 2).tolist() == [4, 5, 6, 7]
    assert batch_rows(8, 2, 0, 2).tolist() == [0, 1, 4, 5]
    assert batch_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert sorted(sum((batch_rows(12, 3, r, 2).tolist() for r in range(2)), [])) == list(range(12))
    with pytest.raises(ValueError, match="does not divide"):
        batch_rows(6, 2, 0, 2)


@pytest.mark.parametrize("affine", [True, False])
def test_plain_global_batch_norm_rounds_a_bf16_gradient_once(affine):
    """The plain global BatchNorm (no group) on a bf16 input: its output and
    input gradient lie within one bf16 ulp (2^-7 relative) plus 1e-4 of
    their rms of the same function in float64 on the same values (x is cast
    to float32 once, so the gradient's float32 sum is rounded once, not
    each use's share on its own)."""
    from unet_zoo_tpu_torch.nn.blocks import global_batch_norm_reference

    gen = torch.Generator().manual_seed(24)
    r = lambda *shape: torch.randn(*shape, generator=gen)
    x = (3 * r(4, 24, 33, 17) + torch.linspace(-5, 5, 24).view(1, -1, 1, 1)).bfloat16()
    dy = r(4, 24, 33, 17).bfloat16()
    w, b = (1 + 0.1 * r(24), 0.1 * r(24)) if affine else (None, None)

    def run(cast):
        leaves = [cast(t).detach().requires_grad_() for t in (x, w, b) if t is not None]
        y, _, _ = global_batch_norm_reference(*(leaves if affine else leaves + [None, None]),
                                              1e-5, None)
        return y, torch.autograd.grad(y, leaves[:1], cast(dy))[0]

    for g, ref in zip(run(lambda t: t), run(lambda t: t.double())):
        assert g.dtype == torch.bfloat16
        g, rms = g.double(), ref.pow(2).mean().sqrt()
        assert ((g - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-4 * rms).all()


def test_runtime_of_a_rank(monkeypatch):
    """Each rank holds rows [r B/N, (r+1) B/N) (``process_batch_slice``),
    rank 0 alone is primary, its shards stay its own rows
    (``make_global_batch``), fsdp lays parameters by rows and keeps the
    running statistics whole; a plain process (no launcher) starts no group."""
    r0, r1 = rank_result("runtime")
    assert (r0["slice"], r1["slice"]) == ((0, 2), (2, 4))
    assert (r0["primary"], r1["primary"]) == (True, False)
    assert r0["global_batch"] == (2, 3, SIZE, SIZE)
    for name, placements in r0["layouts"].items():
        want = "Replicate" if "running" in name or "num_batches" in name else "Shard"
        assert placements == (want,), name
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed(device="cpu") is False and not dist.is_initialized()


@pytest.mark.parametrize("name", ["unet", "gated"])
def test_dp_step_matches_jax_two_device_step(name):
    """Against JAX's GSPMD step on a 2-device mesh: loss within 1e-4, as
    ``tests/test_distributed.py`` holds 8 devices to one, and the running
    statistics within 1e-5 (post-update parameters are not compared: AdamW's
    first step is +-lr sign(g), and near-zero gradients flip sign)."""
    metrics, stats = jax_two_device_step(name)
    got = rank_result(f"{name}_dp")[0]
    assert abs(got["loss"] - metrics["loss"]) < 1e-4, (got["loss"], metrics["loss"])
    assert abs(got["dice"] - metrics["dice"]) < 1e-4
    for n, s in stats.items():
        np.testing.assert_allclose(got["stats"][n].numpy(), s.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)


def test_shard_map_step_matches_jax():
    """The per-replica step against JAX's ``make_train_step_shard_map``: each
    rank's BatchNorm over its own rows, loss and Dice the ranks' mean (loss
    within 1e-4), running statistics averaged (1e-5); and it is not the
    global step (per-rank statistics move the loss)."""
    metrics, stats = jax_two_device_step("unet", shard_map=True)
    got = rank_result("unet_shard_map")[0]
    assert abs(got["loss"] - metrics["loss"]) < 1e-4, (got["loss"], metrics["loss"])
    assert abs(got["dice"] - metrics["dice"]) < 1e-4
    for n, s in stats.items():
        np.testing.assert_allclose(got["stats"][n].numpy(), s.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    assert abs(got["loss"] - rank_result("unet_dp")[0]["loss"]) > 1e-4


@pytest.mark.parametrize("key", ["unet_dp", "unet64_dp", "gated_dp", "resunet_accum_dp"])
def test_dp_step_equals_one_process(key):
    """The 2-rank step computes the one-process step: loss, Dice, every
    clipped gradient, the running statistics; both ranks alike; also with
    two microbatches and on-device flips (``resunet``, narrow).

    Random-weight ``unet`` at 32px is ill-conditioned in float32: the
    one-process step's own gradients lie up to 1.9e-2 of their tensor's
    largest entry from a float64 run (``down_convolution_3``, whose
    BatchNorms see 64 values a channel), beyond the 1e-2 bar, so a summation
    in another order moves them past it. Its float32 step is held in loss,
    Dice and statistics; its gradients in the same step run in float64
    (``unet64``), where no rounding flips a ReLU."""
    r0, r1 = rank_result(key)
    ref = single(key.split("_")[0])
    for got in (r0, r1):
        assert got["step"] == 1
        assert_same_step(got, ref, check_grads=key != "unet_dp")
    assert r0["crc"] == r1["crc"]


def test_fsdp_step_equals_dp_step():
    """fsdp computes the DP step: loss, Dice, gradients, statistics, and the
    updated parameters where the gradient is resolved (elsewhere AdamW's
    first step may take the other sign of a noise-level gradient)."""
    for got, dp in zip(rank_result("unet_fsdp"), rank_result("unet_dp")):
        assert_same_step(got, dp)
    assert rank_result("unet_fsdp")[0]["crc"] == rank_result("unet_fsdp")[1]["crc"]
    got, dp = rank_result("unet_fsdp")[0], rank_result("unet_dp")[0]
    for name, p in dp["params"].items():
        g = dp["grads"][name]
        resolved = g.abs() > 1e-3 * g.abs().max() + 1e-6
        diff = (got["params"][name] - p).abs()
        assert not resolved.any() or diff[resolved].max().item() <= 1e-6, name
        assert diff.max().item() <= 2.01 * LR, name


def test_fsdp_holds_a_share_of_the_bytes():
    """Each rank holds rows [r d0/2, (r+1) d0/2) of every parameter's first
    dimension, so at most half of the parameter and moment bytes plus one
    row a parameter of padding."""
    total = sum(p.numel() * 4 for p in create_model("unet", device="cpu").module.parameters())
    params = dict(create_model("unet", device="cpu").module.named_parameters())
    pad = sum(4 * p[0].numel() for p in params.values())
    shares = rank_result("fsdp_bytes")
    for r, b in enumerate(shares):
        assert b["params"] <= total / 2 + pad and b["moments"] <= 2 * (total / 2 + pad), b
    assert sum(b["params"] for b in shares) == total
    rows = rank_result("fsdp_rows")
    for name, p in params.items():
        assert rows[0][name][0] + rows[1][name][0] == p.shape[0], name


def test_fsdp_checkpoint_is_whole_and_written_once():
    """Written under fsdp on 2 ranks by rank 0 alone (rank 1 saves nothing),
    whole: it holds the gathered parameters and restores bit for bit in one
    process (``test_torch_parallel_loop.py`` restores one on 4 ranks)."""
    assert [r["saves"] for r in launch()] == [1, 0]
    saved = checkpoint.load_checkpoint(os.path.join(shared_dir(), "fsdp_ckpt"))
    r0 = launch()[0]["unet_fsdp"]
    for name, p in r0["params"].items():
        assert torch.equal(saved["variables"][name], p), name
    model = create_model("unet", device="cpu")
    model.module.load_state_dict(saved["variables"], strict=True)
    for name, t in model.module.state_dict().items():
        assert torch.equal(t, saved["variables"][name]), name
    opt = create_train_state(model).optimizer.adamw
    opt.load_state_dict(saved["opt_state"])
    assert len(opt.state) == len(list(model.module.parameters()))


def test_vnet_sharded_predictor_takes_global_statistics():
    """vnet's BatchNorm normalises by the batch's statistics in eval too: a
    predictor over 2 ranks returns on each the one-process output of the
    whole batch (1e-5), which per-rank statistics would not."""
    vnet = create_model("vnet", device="cpu", seed=3)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (BATCH, 3, SIZE, SIZE)).astype(np.float32))
    ref = make_predictor(vnet, None, "logits", cast_bf16=False)(x)
    half = make_predictor(vnet, None, "logits", cast_bf16=False)(x[:2])
    for got in rank_result("vnet"):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert (half - ref[:2]).abs().max().item() > 1e-3


def test_moe_load_balancing_term_is_the_global_batch_s():
    """Each MoE block's term under DP (the ranks' terms averaged) equals one
    process's on the global batch, and a 256-token group that would span two
    ranks raises, naming the shape."""
    ref = moe_terms()["terms"]
    for got in rank_result("moe"):
        np.testing.assert_allclose(got["terms"].numpy(), ref.numpy(), rtol=1e-5, atol=1e-7)
        assert "would span two ranks" in got["spans"] and "shape" in got["spans"]


def test_k7_reference_sums_over_a_group_of_one():
    """K7's plain version inside a data group of one computes what it does
    outside one (the moments from float64 sums), gradients included."""
    from unet_zoo_tpu_torch.parallel import global_batch_statistics

    rng = np.random.default_rng(11)
    n, length, g, gp, ks = 6, 8, 2, 4, 10
    c = gp // 2
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    args = [t(n, length, g, c), t(n, length, g, c), t(n, length, g, c), t(n, length, g, c),
            t(n, length, g, gp), t(2 * gp, 2 * ks - 1), t(3, g).abs() + 0.5]
    tmp = shared_dir()
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"file://{tmp}/k7_store", rank=0,
                                world_size=1)
    try:
        outs = []
        for group in (None, dist.group.WORLD):
            leaves = [a.clone().requires_grad_() for a in args]
            with global_batch_statistics(group):
                sv, sve, mu, var = k7.fused_axial_train(*leaves, ks)
            (sv.square().sum() + sve.sum()).backward()
            outs.append([sv, sve, mu, var] + [a.grad for a in leaves])
        for a, b in zip(*outs):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                       atol=1e-6)
    finally:
        dist.destroy_process_group()
