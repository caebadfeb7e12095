"""The training loop and the train CLI over gloo ranks (CPU).

``train_model`` runs DataParallel and fsdp on 2 ranks (child processes that
import only torch and the port, as in ``test_torch_parallel.py``) over the
JAX test's synthetic set (``tests/test_distributed.py:141``) with a narrow
``resunet``: every rank reads the same epoch losses and Dice, those of one
process; only rank 0 writes the logs, the TensorBoard events and the
checkpoints; a last validation batch that does not divide over the ranks
raises, as JAX's ``device_put`` of it does. fsdp's last checkpoint restores
bit for bit on 4 ranks and resumes training in one process. The strategies
not ported yet raise, naming their ROADMAP items. One ``torchrun``-style run
of ``cli.train`` on two processes (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``) trains, rank 0 alone writing.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel import Ranks, shared_dir
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.config import Config
from unet_zoo_tpu_torch.data import DataLoader, SyntheticDataset
from unet_zoo_tpu_torch.parallel import create_mesh, initialize_distributed, is_primary
from unet_zoo_tpu_torch.parallel import shard_state_fsdp
from unet_zoo_tpu_torch.parallel.fsdp import sharded_bytes
from unet_zoo_tpu_torch.parallel.multihost import fully_replicate_to_host
from unet_zoo_tpu_torch.train import create_train_state
from unet_zoo_tpu_torch.train.loop import train_model, validate_one_epoch
from unet_zoo_tpu_torch.train.steps import make_eval_step
from unet_zoo_tpu_torch.utils import checkpoint
from unet_zoo_tpu_torch.utils.logger import Logger

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SIZE = 32
FILTERS = (8, 16, 16, 16)
STRATEGIES = ("DataParallel", "fsdp")


def child(scenario: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    assert initialize_distributed(f"file://{os.path.join(tmp, scenario + '_store')}",
                                  world_size=world, rank=rank, device="cpu")
    try:
        out = SCENARIOS[scenario](tmp, rank)
        assert "jax" not in sys.modules and "unet_zoo_tpu" not in sys.modules
        torch.save(out, os.path.join(tmp, f"{scenario}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def loop_dict(root, strategy, epochs=2):
    """The JAX strategy test's config (``tests/test_distributed.py:141``)."""
    return {
        "general": {"project_name": "t", "working_dir": str(root)},
        "data": {"dataset_dir": "unused", "num_workers": 1, "image_size": SIZE},
        "training": {"epochs": epochs, "batch_size": 4, "learning_rate": 1e-3,
                     "early_stopping_patience": 20, "lr_scheduler_patience": 8,
                     "lr_scheduler_factor": 0.2, "min_lr": 1e-7, "num_classes": 1},
        "gpu": {"use_multi_gpu": True, "gpu_ids": [], "single_gpu_id": 0,
                "multi_gpu_strategy": strategy},
        "run_timestamp": "fixed",
    }


def loaders(val_length=4):
    return (DataLoader(SyntheticDataset(8, SIZE), 4, shuffle=True, drop_last=True, num_workers=0),
            DataLoader(SyntheticDataset(val_length, SIZE, seed=1), 4, num_workers=0))


def run_loop(root, strategy, mesh=None, epochs=2, resume=False, log_path=None):
    cfg = Config(loop_dict(root, strategy, epochs), create_dirs=is_primary(), device="cpu")
    model = create_model("resunet", device="cpu", seed=0, filters=FILTERS)
    logger = Logger(log_path or os.path.join(str(root), "log.txt"))
    try:
        return train_model(model, *loaders(), cfg, "resunet", os.path.join(str(root), "best"),
                           os.path.join(str(root), "last"), logger, mesh=mesh, resume=resume)
    finally:
        logger.close()


def _loop(tmp, rank):
    mesh = create_mesh(device_type="cpu")
    out = {}
    for strategy in STRATEGIES:
        root = os.path.join(tmp, strategy)
        out[strategy] = run_loop(root, strategy, mesh,
                                 log_path=os.path.join(root, f"rank{rank}_log.txt"))
    model = create_model("resunet", device="cpu", seed=0, filters=FILTERS)
    try:
        validate_one_epoch(make_eval_step(model, mesh=mesh), None, loaders(5)[1], "resunet",
                           Logger(None), mesh=mesh)
        out["ragged"] = None
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def _restore4(tmp, rank):
    """fsdp's last checkpoint restored, sharded over 4 ranks, gathered whole."""
    mesh = create_mesh(device_type="cpu")
    model = create_model("resunet", device="cpu", seed=1, filters=FILTERS)
    state = create_train_state(model)
    saved = checkpoint.load_checkpoint(os.path.join(tmp, "fsdp", "last"))
    model.module.load_state_dict(saved["variables"], strict=True)
    state.optimizer.adamw.load_state_dict(saved["opt_state"])
    shard_state_fsdp(mesh, state)
    return {"variables": fully_replicate_to_host(model.module.state_dict()),
            "opt_state": fully_replicate_to_host(state.optimizer.adamw.state_dict()),
            "bytes": sharded_bytes(state)}


SCENARIOS = {"loop": _loop, "restore4": _restore4}


def loop_dir():
    return os.path.join(shared_dir(), "loop")


_RUNS = {}


def start(scenario, world):
    """The ranks of ``scenario``, started once for the file."""
    if scenario not in _RUNS:
        os.makedirs(loop_dir(), exist_ok=True)
        _RUNS[scenario] = Ranks("test_torch_parallel_loop", scenario, world, loop_dir())
    return _RUNS[scenario]


def ranks(scenario, world):
    if scenario == "restore4":
        ranks("loop", 2)
    return start(scenario, world).result()


@pytest.fixture(scope="module")
def single_process(tmp_path_factory):
    """The loop in one process, run while the ranks run theirs."""
    start("loop", 2)
    return run_loop(tmp_path_factory.mktemp("one"), "DataParallel")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_train_model_over_two_ranks_is_one_process(single_process, strategy):
    """Both ranks return the same epoch losses and Dice, the one-process
    loop's under either strategy, and the same early-stopping answer: train
    losses within 1e-5 relative, Dice within 2e-3, as ``test_torch_loop.py``
    holds the loop to JAX's (a thresholded pixel that float rounding moves
    across 0.5 moves a 32px batch's Dice by about 3e-5). Validation losses
    within 1e-3: the conv biases in front of train-mode BatchNorms have zero
    gradients but for rounding, AdamW moves them +-lr by the sign of that
    noise, and eval-mode BatchNorm (running statistics) lets them through to
    the logits (read: 3.2e-4 relative at epoch 2; the train losses, which
    BatchNorm keeps them out of, agree to 1e-6)."""
    r0, r1 = (r[strategy] for r in ranks("loop", 2))
    assert r0 == r1
    train_loss, train_dice, val_loss, val_dice, stopped = single_process
    np.testing.assert_allclose(r0[0], train_loss, rtol=1e-5)
    np.testing.assert_allclose(r0[2], val_loss, rtol=1e-3)
    np.testing.assert_allclose(r0[1], train_dice, rtol=0, atol=2e-3)
    np.testing.assert_allclose(r0[3], val_dice, rtol=0, atol=2e-3)
    assert r0[4] == stopped


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_only_rank_zero_writes(strategy):
    """Rank 0 writes the epoch log, the events and both checkpoints; rank 1's
    logger gets nothing past its own header."""
    ranks("loop", 2)
    root = os.path.join(loop_dir(), strategy)
    assert "resunet - Epoch 2/2" in open(os.path.join(root, "rank0_log.txt")).read()
    assert "Epoch" not in open(os.path.join(root, "rank1_log.txt")).read()
    events = os.path.join(root, "overall_runs_fixed", "tensorboard_logs", "resunet")
    assert len(os.listdir(events)) == 1
    assert checkpoint.checkpoint_exists(os.path.join(root, "best"))
    assert checkpoint.checkpoint_exists(os.path.join(root, "last"))


def test_ragged_validation_batch_raises_as_jax():
    """A last validation batch of 1 over 2 ranks raises, naming its rows and
    the data axis, as JAX's ``device_put`` onto the batch sharding does (the
    loader's sampler, which loads only the rank's rows, refuses it)."""
    msg = ranks("loop", 2)[0]["ragged"]
    assert msg and "global batch of 1 rows" in msg and "2-way data axis" in msg


def test_fsdp_checkpoint_restores_on_four_ranks_and_resumes_in_one(tmp_path):
    """fsdp's last checkpoint, written on 2 ranks, restores bit for bit
    sharded over 4 ranks (each holding at most a quarter of the parameter
    bytes plus a row a parameter), and one process resumes from it for a
    third epoch."""
    saved = checkpoint.load_checkpoint(os.path.join(loop_dir(), "fsdp", "last"))
    params = create_model("resunet", device="cpu", filters=FILTERS).module.named_parameters()
    pad = sum(4 * p[0].numel() for _, p in params)
    total = sum(t.numel() * 4 for n, t in saved["variables"].items()
                if "running" not in n and "num_batches" not in n)
    for got in ranks("restore4", 4):
        for name, t in saved["variables"].items():
            assert torch.equal(got["variables"][name], t), name
        for i, st in saved["opt_state"]["state"].items():
            for k, v in st.items():
                assert torch.equal(got["opt_state"]["state"][i][k], v), (i, k)
        assert got["bytes"]["params"] <= total / 4 + pad
    root = tmp_path / "resume"
    checkpoint.save_checkpoint(str(root / "last"), saved)
    losses = run_loop(root, "DataParallel", epochs=3, resume=True)
    assert len(losses[0]) == 1 and np.isfinite(losses[0][0])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_sharded_sampler_loads_only_each_ranks_rows(microbatches):
    """Under a mesh the loader's sampler yields each rank its rows of every
    global batch (``batch_rows``: microbatch by microbatch), in the
    one-process shuffled order, so no rank loads another's items; a last
    global batch that does not divide over the ranks raises."""
    from unet_zoo_tpu_torch.data.loader import EpochBatchSampler
    from unet_zoo_tpu_torch.parallel.multihost import batch_rows

    def sampler(length, shard=None):
        s = EpochBatchSampler(length, 8, shuffle=True, seed=3)
        s.shard = shard
        return s

    whole = list(sampler(32))
    parts = [list(sampler(32, (rank, 2, microbatches))) for rank in range(2)]
    for b, batch in enumerate(whole):
        for rank in range(2):
            rows = batch_rows(8, microbatches, rank, 2).tolist()
            assert parts[rank][b] == [batch[i] for i in rows]
        assert sorted(parts[0][b] + parts[1][b]) == sorted(batch)
    with pytest.raises(ValueError, match="global batch of 5 rows does not divide over the 2-way"):
        list(sampler(21, (0, 2, microbatches)))


@pytest.mark.parametrize("strategy,item", [("tensor_parallel", "10c"), ("expert", "10c"),
                                           ("pipeline", "10b"), ("spatial", "10b")])
def test_strategies_still_to_port_raise(tmp_path, strategy, item):
    cfg = Config(loop_dict(tmp_path, strategy), device="cpu")
    model = create_model("resunet", device="cpu", filters=FILTERS)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        train_model(model, *loaders(), cfg, "resunet", "b", "l", Logger(None), mesh=object())


def test_world_size_is_the_launchers(monkeypatch):
    """Under a launcher of 2 processes ``device_count`` is the world size,
    bounded by ``tpu.num_devices``; a mesh refuses a bound below the world
    and a batch that does not divide over it, naming both (ROADMAP Queue 3:
    JAX's mesh would leave devices out; here every rank is in every
    collective). Without a launcher, two visible cards raise."""
    from unet_zoo_tpu_torch.parallel import create_mesh_for_batch, multihost

    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    d = loop_dict("unused", "DataParallel")
    assert Config(d, create_dirs=False, device="cpu").device_count() == 2
    d["tpu"] = {"num_devices": 1}
    bound = Config(d, create_dirs=False, device="cpu").device_count()
    assert bound == 1
    with pytest.raises(ValueError, match="2 processes but at most 1 devices"):
        create_mesh_for_batch(4, bound)
    with pytest.raises(ValueError, match="batch_size 3 does not divide over the 2-way data axis"):
        create_mesh_for_batch(3)
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="torchrun --nproc-per-node 2"):
        Config(loop_dict("unused", "DataParallel"), create_dirs=False).device_count()


def test_one_process_multi_gpu_run_takes_the_plain_step(tmp_path, monkeypatch):
    """``cli.train`` with ``use_multi_gpu: true`` but no launcher is one
    process on one device: it starts no process group, builds no mesh, and
    the loop trains with the plain step (the mesh it gets is None). A mesh
    asked for without a device type and without ``initialize_distributed``
    raises rather than guess one."""
    import yaml

    from test_torch_loop import _png_set
    from unet_zoo_tpu_torch.cli import train as cli
    from unet_zoo_tpu_torch.parallel import multihost
    from unet_zoo_tpu_torch.train import loop

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setitem(multihost._RUNTIME, "device_type", None)
    with pytest.raises(ValueError, match="no device type for the mesh"):
        create_mesh()
    assert not dist.is_initialized()

    _png_set(tmp_path / "data", size=SIZE)
    cfg = {
        "general": {"project_name": "t", "working_dir": str(tmp_path / "runs")},
        "data": {"dataset_dir": str(tmp_path / "data"), "num_workers": 0, "image_size": SIZE},
        "training": {"epochs": 1, "batch_size": 2, "learning_rate": 1e-3,
                     "early_stopping_patience": 3, "lr_scheduler_patience": 1,
                     "lr_scheduler_factor": 0.5, "min_lr": 1e-6, "num_classes": 1},
        "gpu": {"use_multi_gpu": True, "multi_gpu_strategy": "DataParallel"},
        "models": {"names": ["resunet"], "params": {"resunet": {"filters": list(FILTERS)}}},
        "run_timestamp": "fixed",
    }
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    meshes, steps = [], []
    real_loop, real_step = cli.train_model, loop.make_train_step

    def train_model(*args, mesh=None, **kwargs):
        meshes.append(mesh)
        return real_loop(*args, mesh=mesh, **kwargs)

    def make_train_step(*args, mesh=None, **kwargs):
        steps.append(mesh)
        return real_step(*args, mesh=mesh, **kwargs)

    monkeypatch.setattr(cli, "train_model", train_model)
    monkeypatch.setattr(loop, "make_train_step", make_train_step)
    cli.main(["--config", str(tmp_path / "train.yaml"), "--device", "cpu"])
    assert meshes == [None] and steps == [None]
    assert not dist.is_initialized()
    run = tmp_path / "runs" / "overall_runs_fixed" / "resunet"
    assert checkpoint.checkpoint_exists(str(run / "checkpoints" / "resunet_last"))
    assert "Parallelism" not in (run / "logs" / "training_log.txt").read_text()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_torchrun_style_cli_run(tmp_path):
    """``cli.train`` on two processes launched as ``torchrun`` launches them
    (the rendezvous on a localhost port): both exit 0; the run's logs hold
    one copy of each line they log, and the checkpoints exist."""
    import yaml

    from test_torch_loop import _png_set

    _png_set(tmp_path / "data", size=SIZE)
    cfg = {
        "general": {"project_name": "t", "working_dir": str(tmp_path / "runs")},
        "data": {"dataset_dir": str(tmp_path / "data"), "num_workers": 0, "image_size": SIZE},
        "training": {"epochs": 1, "batch_size": 2, "learning_rate": 1e-3,
                     "early_stopping_patience": 3, "lr_scheduler_patience": 1,
                     "lr_scheduler_factor": 0.5, "min_lr": 1e-6, "num_classes": 1},
        "gpu": {"use_multi_gpu": True, "multi_gpu_strategy": "DataParallel"},
        "models": {"names": ["resunet"], "params": {"resunet": {"filters": list(FILTERS)}}},
        "run_timestamp": "fixed",
    }
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(cfg))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "unet_zoo_tpu_torch.cli.train", "--config",
             str(tmp_path / "train.yaml"), "--device", "cpu"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    run = tmp_path / "runs" / "overall_runs_fixed"
    overall = (run / "overall_logs" / "overall_training_log.txt").read_text()
    assert overall.count("TRAINING RUN") == 1 and "x2" in overall
    log = (run / "resunet" / "logs" / "training_log.txt").read_text()
    assert log.count("resunet - Epoch 1/1") == 1 and log.count("Log started") == 1
    assert "Parallelism: dataparallel over mesh {'data': 2, 'model': 1}" in log
    ckpts = run / "resunet" / "checkpoints"
    assert checkpoint.checkpoint_exists(str(ckpts / "resunet_best"))
    assert checkpoint.checkpoint_exists(str(ckpts / "resunet_last"))
