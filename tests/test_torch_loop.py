"""The port's training loop against the JAX package (CPU): the Dice-plateau
scheduler, early stopping, the config, the TensorBoard writer and logger,
the loop itself on a tiny two-head model, resume, and the train and
evaluate CLIs end to end."""

import dataclasses
import glob
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_train import _JaxTiny, _off_zero, _Tiny, _tiny_state_dict
from unet_zoo_tpu import config as jax_config
from unet_zoo_tpu.data import SyntheticDataset as JaxSynthetic
from unet_zoo_tpu.data.loader import DataLoader as JaxLoader
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.train import early_stopping as jax_es
from unet_zoo_tpu.train import loop as jax_loop
from unet_zoo_tpu.train import lr_scheduler as jax_sched
from unet_zoo_tpu.train import steps as jax_steps
from unet_zoo_tpu.utils import logger as jax_logger
from unet_zoo_tpu.utils import tb_writer as jax_tb
from unet_zoo_tpu_torch.cli import evaluate as cli_evaluate
from unet_zoo_tpu_torch.cli import train as cli_train
from unet_zoo_tpu_torch.config import Config
from unet_zoo_tpu_torch.data import DataLoader, SyntheticDataset
from unet_zoo_tpu_torch.models import _REGISTRY, ZooModel
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.train.early_stopping import EarlyStopping
from unet_zoo_tpu_torch.train.loop import restore_checkpoint, train_model
from unet_zoo_tpu_torch.train.lr_scheduler import DiceScheduler
from unet_zoo_tpu_torch.utils import tb_writer
from unet_zoo_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint
from unet_zoo_tpu_torch.utils.logger import Logger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- scheduler and early stopping ----------------------------------------------


def _scores(seed, n=24):
    """A seeded score walk with plateaus, repeats and falls, so that every
    branch of both state machines runs (first score, improvement, counter,
    cut, cut at the minimum)."""
    rng = np.random.default_rng(seed)
    steps = rng.choice([0.0, 0.0, 0.002, -0.01, 0.05, 0.0005], size=n)
    return [float(v) for v in np.round(0.5 + np.cumsum(steps), 6)]


def _run_both(capsys, makers, feed, scores):
    """(returns, printed lines, final state_dict) of each maker's object fed
    ``scores`` one epoch at a time."""
    outs = []
    for make in makers:
        obj = make()
        returned = [feed(obj, i, s) for i, s in enumerate(scores)]
        outs.append((returned, capsys.readouterr().out.splitlines(), obj.state_dict()))
    return outs


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dice_scheduler_matches_jax(capsys, seed, mode):
    """Every returned rate, printed line and the state_dict, step by step."""
    kw = dict(lr=1e-3, patience=2, factor=0.5, min_lr=2e-4, min_delta=0.001, mode=mode)
    (jr, jp, js), (pr, pp, ps) = _run_both(
        capsys, [lambda: jax_sched.DiceScheduler(**kw), lambda: DiceScheduler(**kw)],
        lambda obj, i, s: (obj.step(s, i + 1), obj.state_dict()), _scores(seed))
    assert pr == jr and pp == jp and ps == js
    assert any("Reducing" in line for line in jp) and any("minimum" in line for line in jp)


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_early_stopping_matches_jax(capsys, seed, mode):
    """Every return value, printed line and the state_dict, step by step."""
    weights = {"w": torch.zeros(2)}
    kw = dict(patience=3, min_delta=0.001, mode=mode)
    (jr, jp, js), (pr, pp, ps) = _run_both(
        capsys, [lambda: jax_es.EarlyStopping(**kw), lambda: EarlyStopping(**kw)],
        lambda obj, i, s: (obj(s, weights, i + 1), obj.state_dict()), _scores(seed))
    assert pr == jr and pp == jp and ps == js
    assert any(r[0] for r in jr)


def test_early_stopping_best_weights_do_not_move():
    """The best weights are a copy: a later train step moves the module's
    parameters and buffers, not them."""
    model = _tiny_port()
    state = create_train_state(model, learning_rate=1e-2)
    es = EarlyStopping(patience=2, verbose=False)
    es(0.5, state.module.state_dict(), 1)
    saved = {k: v.clone() for k, v in es.best_weights.items()}
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    masks = torch.from_numpy((rng.random((2, 1, 8, 8)) > 0.5).astype(np.float32))
    make_train_step(model)(state, images, masks)
    live = state.module.state_dict()
    assert any(not torch.equal(live[k], saved[k]) for k in saved)
    for k, v in es.best_weights.items():
        assert torch.equal(v, saved[k]), k


# --- config ---------------------------------------------------------------------


def _config_dict(path):
    with open(path) as f:
        d = yaml.safe_load(f)
    # the fallback timestamp reads the clock to the second on each side
    d.setdefault("run_timestamp", "fixed")
    return d


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_config_matches_jax(path):
    """Every UPPERCASE attribute of the JAX Config, equal in the port's; an
    evaluation config (no training section) is refused by both."""
    if "training" not in _config_dict(path):
        for cls in (jax_config.Config, Config):
            with pytest.raises(KeyError, match="training"):
                cls(_config_dict(path), create_dirs=False)
        return
    want = jax_config.Config(_config_dict(path), create_dirs=False)
    got = Config(_config_dict(path), create_dirs=False)
    names = [n for n in vars(want) if n.isupper()]
    assert names
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert got.DEVICE == torch.device("cuda")


def test_config_devices(monkeypatch):
    """One device without use_multi_gpu; use_multi_gpu over more than one
    device raises; over one it runs there."""
    d = _config_dict(os.path.join(REPO, "configs", "default_train_config.yaml"))
    d["gpu"] = {"use_multi_gpu": True}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        Config(d, create_dirs=False).device_count()
    d["tpu"] = {"num_devices": 1}
    assert Config(d, create_dirs=False).device_count() == 1
    d["gpu"] = {"use_multi_gpu": False}
    cpu = Config(d, create_dirs=False, device="cpu")
    assert cpu.device_count() == 1 and cpu.get_device_info().startswith("CPU (")


# --- TensorBoard writer and logger ----------------------------------------------


def test_tb_writer_bytes_match_jax(tmp_path, monkeypatch):
    """The same scalars at a fixed wall time give the same file, byte for
    byte, and read back."""
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    scalars = [("Batch/unet_Train_Loss", 0.6931, 0), ("Epoch/unet_Val_Dice", 0.125, 3),
               ("unet_Learning_Rate", 1e-4, 12345678)]
    paths = []
    for mod, sub in ((jax_tb, "jax"), (tb_writer, "port")):
        w = mod.EventFileWriter(str(tmp_path / sub))
        for tag, value, step in scalars:
            w.add_scalar(tag, value, step)
        w.close()
        paths.append(w._path)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1]
    got = tb_writer.read_scalar_events(paths[1])
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, _, s in scalars]
    np.testing.assert_allclose([v for *_, v in got], [v for _, v, _ in scalars], rtol=1e-7)


def test_logger_files_match_jax(tmp_path, capsys):
    """Both loggers write the same file and print the same lines."""
    texts = []
    for cls, name in ((jax_logger.Logger, "jax.txt"), (Logger, "port.txt")):
        with cls(str(tmp_path / "logs" / name)) as log:
            log.log_both("epoch 1: loss 0.5")
            log.log_file_only("batch 0: loss 0.7")
        texts.append((tmp_path / "logs" / name).read_text())
    stamp = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d")
    assert stamp.sub("T", texts[0]) == stamp.sub("T", texts[1])
    assert "batch 0: loss 0.7" in texts[1]
    assert capsys.readouterr().out == "epoch 1: loss 0.5\n" * 2


# --- the loop -------------------------------------------------------------------


def _loop_dict(tmp_path, epochs, augment=False):
    return {
        "general": {"project_name": "t", "working_dir": str(tmp_path)},
        "data": {"dataset_dir": "unused", "num_workers": 1, "image_size": 16,
                 "augment": augment, "augment_on_device": augment},
        "training": {
            "epochs": epochs, "batch_size": 4, "learning_rate": 3e-2,
            "early_stopping_patience": 2, "lr_scheduler_patience": 1,
            "lr_scheduler_factor": 0.5, "min_lr": 1e-4, "num_classes": 1,
        },
        "run_timestamp": "fixed",
    }


def _tiny_port():
    """The tiny model under the 'unet' registry entry (its loss weights)."""
    return ZooModel(name="unet", module=_Tiny(), spec=_REGISTRY["unet"], in_channels=3,
                    num_classes=1, image_size=None)


def _tiny_pair(lr):
    jm = dataclasses.replace(jax_create_model("unet"), module=_JaxTiny())
    pm = _tiny_port()
    jstate = _off_zero(jax_steps.create_train_state(jm, jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 16, 16, 3)), learning_rate=lr))
    pm.module.load_state_dict(_tiny_state_dict({"params": jstate.params,
                                                "batch_stats": jstate.batch_stats}))
    return jm, jstate, pm


def _state_lines(out):
    return [line for line in out.splitlines()
            if line.startswith(("DiceScheduler", "EarlyStopping", "Reducing", "Learning rate"))]


def test_train_model_matches_jax(tmp_path, capsys, monkeypatch):
    """JAX's train_model and the port's from the same weights on the same
    SyntheticDataset batches, 4 epochs, LR patience 1 and early-stopping
    patience 2: per-epoch train and val loss within 1e-5 relative, Dice
    within 2e-3; the learning rates, the scheduler's and early stopping's
    lines and the stop epoch equal."""
    # JAX's loop writes through torch's SummaryWriter where tensorboard is
    # installed (its import takes seconds here); its own writer is the one
    # the port copies
    monkeypatch.setattr(jax_loop, "_make_writer", jax_tb.EventFileWriter)
    d = _loop_dict(tmp_path / "jax", 4)
    jm, jstate, pm = _tiny_pair(d["training"]["learning_rate"])
    runs = {}
    for side in ("jax", "port"):
        cfg_dict = _loop_dict(tmp_path / side, 4)
        if side == "jax":
            cfg = jax_config.Config(cfg_dict)
            train = JaxLoader(JaxSynthetic(16, 16), 4, shuffle=True, drop_last=True,
                              seed=0, num_workers=1)
            val = JaxLoader(JaxSynthetic(8, 16, seed=1), 4, num_workers=1)
            log = jax_logger.Logger(str(tmp_path / side / "log.txt"))
            out = jax_loop.train_model(jm, train, val, cfg, "unet", str(tmp_path / side / "b"),
                                       str(tmp_path / side / "l"), log, state=jstate)
            train.close()
            val.close()
        else:
            cfg = Config(cfg_dict, device="cpu")
            train = DataLoader(SyntheticDataset(16, 16), 4, shuffle=True, drop_last=True,
                               seed=0, num_workers=0)
            val = DataLoader(SyntheticDataset(8, 16, seed=1), 4, num_workers=0)
            log = Logger(str(tmp_path / side / "log.txt"))
            out = train_model(pm, train, val, cfg, "unet", str(tmp_path / side / "b"),
                              str(tmp_path / side / "l"), log)
        log.close()
        text = (tmp_path / side / "log.txt").read_text()
        runs[side] = dict(out=out, lines=_state_lines(capsys.readouterr().out),
                          lrs=re.findall(r"Learning Rate: (\S+)", text),
                          stop=re.findall(r"Early stopping triggered for unet at epoch (\d+)", text))
    (jtl, jtd, jvl, jvd, jstop), (tl, td, vl, vd, stop) = runs["jax"]["out"], runs["port"]["out"]
    assert stop == jstop and len(tl) == len(jtl) and runs["port"]["stop"] == runs["jax"]["stop"]
    np.testing.assert_allclose(tl, jtl, rtol=1e-5)
    np.testing.assert_allclose(vl, jvl, rtol=1e-5)
    np.testing.assert_allclose(td, jtd, rtol=0, atol=2e-3)
    np.testing.assert_allclose(vd, jvd, rtol=0, atol=2e-3)
    assert runs["port"]["lrs"] == runs["jax"]["lrs"]
    assert runs["port"]["lines"] == runs["jax"]["lines"]
    assert len(set(runs["port"]["lrs"])) > 1        # the rate was cut
    for side in ("jax", "port"):
        assert os.path.isdir(tmp_path / side / "b") and os.path.isdir(tmp_path / side / "l")


def test_resume_equals_straight_run(tmp_path):
    """2 epochs, then resume=True to 4, equal 4 straight epochs bit for bit
    (weights, AdamW state, step, scheduler and early stopping; on-device
    flips keyed off the restored step), with the train loader unshuffled."""
    results = {}
    for run in ("straight", "resumed"):
        root = tmp_path / run
        _, _, pm = _tiny_pair(3e-2)
        best, last = str(root / "best"), str(root / "last")
        loaders = (DataLoader(SyntheticDataset(12, 16), 4, drop_last=True, num_workers=0),
                   DataLoader(SyntheticDataset(8, 16, seed=1), 4, num_workers=0))
        log = Logger(str(root / "log.txt"))
        if run == "resumed":
            cfg = Config(_loop_dict(root, 2, augment=True), device="cpu")
            first = train_model(pm, *loaders, cfg, "unet", best, last, log)
            assert load_checkpoint(last)["meta"]["epoch"] == 2
            _, _, pm = _tiny_pair(3e-2)             # a new model: the restore must set it
            with torch.no_grad():
                for p in pm.module.parameters():
                    p.add_(1.0)
        cfg = Config(_loop_dict(root, 4, augment=True), device="cpu")
        out = train_model(pm, *loaders, cfg, "unet", best, last, log, resume=run == "resumed")
        log.close()
        if run == "resumed":
            out = tuple(a + b for a, b in zip(first[:4], out[:4])) + out[4:]
        results[run] = dict(out=out, module=pm.module.state_dict(), ckpt=load_checkpoint(last))
    a, b = results["straight"], results["resumed"]
    assert a["out"] == b["out"] and len(a["out"][0]) == 4
    for k, v in a["module"].items():
        assert torch.equal(v, b["module"][k]), k
    for key in ("step", "meta", "scheduler", "early_stopping"):
        assert a["ckpt"][key] == b["ckpt"][key], key
    assert a["ckpt"]["step"] == 12
    sa, sb = a["ckpt"]["opt_state"], b["ckpt"]["opt_state"]
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_restore_checkpoint_sets_everything(tmp_path):
    """restore_checkpoint loads weights, AdamW state, step, learning rate,
    scheduler and early stopping as saved (weights_only load)."""
    _, _, pm = _tiny_pair(3e-2)
    root = tmp_path / "run"
    cfg = Config(_loop_dict(root, 2), device="cpu")
    loaders = (DataLoader(SyntheticDataset(8, 16), 4, num_workers=0),
               DataLoader(SyntheticDataset(4, 16, seed=1), 4, num_workers=0))
    log = Logger(None)
    train_model(pm, *loaders, cfg, "unet", str(root / "best"), str(root / "last"), log)
    saved = load_checkpoint(str(root / "last"))
    _, _, fresh = _tiny_pair(1e-3)
    state = create_train_state(fresh, learning_rate=1e-3)
    sched, es = DiceScheduler(lr=1.0, verbose=False), EarlyStopping(verbose=False)
    assert restore_checkpoint(str(root / "last"), state, sched, es) == 2
    for k, v in saved["variables"].items():
        assert torch.equal(fresh.module.state_dict()[k], v), k
    assert state.step == saved["step"] == 4
    assert state.optimizer.lr == sched.lr == saved["scheduler"]["lr"]
    assert sched.state_dict() == saved["scheduler"]
    assert es.state_dict() == saved["early_stopping"]
    got = state.optimizer.adamw.state_dict()
    for i, st in saved["opt_state"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def test_train_model_refuses_a_mesh(tmp_path):
    """A mesh is laid out by DataParallel or fsdp (tests/test_torch_parallel_loop.py);
    the strategies still to port refuse it, naming their ROADMAP items, and an
    unknown one is refused as JAX refuses it. Without a mesh the strategy is
    not read, as in JAX: fsdp trains on the model's device."""
    _, _, pm = _tiny_pair(1e-3)
    loader = DataLoader(SyntheticDataset(4, 16), 4, num_workers=0)
    d = _loop_dict(tmp_path, 1)
    for strategy, item in (("tensor_parallel", "10c"), ("pipeline", "10b")):
        d["gpu"] = {"use_multi_gpu": True, "multi_gpu_strategy": strategy}
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
            train_model(pm, loader, loader, Config(d, device="cpu"), "unet", "b", "l",
                        Logger(None), mesh=object())
    d["gpu"] = {"use_multi_gpu": True, "multi_gpu_strategy": "hogwild"}
    with pytest.raises(ValueError, match="Unknown multi_gpu_strategy 'hogwild'"):
        train_model(pm, loader, loader, Config(d, device="cpu"), "unet", "b", "l",
                    Logger(None), mesh=object())
    d["gpu"] = {"use_multi_gpu": True, "multi_gpu_strategy": "fsdp"}
    losses = train_model(pm, loader, loader, Config(d, device="cpu"), "unet",
                         str(tmp_path / "b"), str(tmp_path / "l"), Logger(None))[0]
    assert len(losses) == 1 and np.isfinite(losses[0])


# --- the CLIs -------------------------------------------------------------------


def _png_set(root, size=40):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in (("train", 2), ("valid", 2), ("test", 2)):
        for sub in ("images", "masks"):
            (root / split / sub).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
                root / split / "images" / f"{i:03d}.png")
            m = np.zeros((size, size), np.uint8)
            m[8:24, 10:30] = 255
            Image.fromarray(m).save(root / split / "masks" / f"{i:03d}.png")


def _cli(module, config, *args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", f"unet_zoo_tpu_torch.cli.{module}", "--config",
                           str(config), *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_train_and_evaluate_clis(tmp_path):
    """cli.train then cli.evaluate on a 32px PNG set with unet (--device
    cpu): the best and last checkpoints, the logs, the TensorBoard file and
    test_results_summary.txt; a failing model makes cli.evaluate exit 1;
    then cli.train --resume for one more epoch. Without --device the CLIs
    ask for CUDA and raise here."""
    _png_set(tmp_path / "data")
    train_cfg = {
        "general": {"project_name": "t", "working_dir": str(tmp_path / "runs")},
        "data": {"dataset_dir": str(tmp_path / "data"), "num_workers": 0, "image_size": 32,
                 "augment": True, "augment_on_device": True},
        "training": {"epochs": 1, "batch_size": 2, "learning_rate": 1e-3,
                     "early_stopping_patience": 3, "lr_scheduler_patience": 1,
                     "lr_scheduler_factor": 0.5, "min_lr": 1e-6, "num_classes": 1},
        "models": {"names": ["unet"]},
        "run_timestamp": "fixed",
    }
    (tmp_path / "train.yaml").write_text(yaml.safe_dump(train_cfg))
    r = _cli("train", tmp_path / "train.yaml", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    run = tmp_path / "runs" / "overall_runs_fixed"
    ckpts = run / "unet" / "checkpoints"
    assert checkpoint_exists(str(ckpts / "unet_best")) and checkpoint_exists(str(ckpts / "unet_last"))
    assert "unet - Epoch 1/1" in (run / "unet" / "logs" / "training_log.txt").read_text()
    assert "Checking dataset integrity" in (run / "overall_logs" / "overall_training_log.txt").read_text()
    assert glob.glob(str(run / "tensorboard_logs" / "unet" / "events.out.tfevents.*"))

    eval_cfg = {
        "general": {"project_name": "t", "working_dir": str(tmp_path / "runs")},
        "data": {"dataset_dir": str(tmp_path / "data"), "num_workers": 0, "image_size": 32},
        "evaluation": {"batch_size": 2},
        "models": {"models_to_evaluate": [{"name": "unet", "checkpoint": str(ckpts / "unet_best")}]},
        "run_timestamp": "fixed",
    }
    (tmp_path / "eval.yaml").write_text(yaml.safe_dump(eval_cfg))
    r = _cli("evaluate", tmp_path / "eval.yaml", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    summary = (tmp_path / "runs" / "evaluation_fixed" / "test_results_summary.txt").read_text()
    assert "Unet Test Results" in summary and "Test DICE" in summary
    # a model that fails is logged and skipped, and the run then exits 1
    eval_cfg["models"]["models_to_evaluate"][0]["name"] = "no_such_model"
    (tmp_path / "bad.yaml").write_text(yaml.safe_dump(eval_cfg))
    assert cli_evaluate.main(["--config", str(tmp_path / "bad.yaml"), "--device", "cpu"]) == 1
    assert "Error evaluating no_such_model" in (
        tmp_path / "runs" / "evaluation_fixed" / "evaluation_log.txt").read_text()

    train_cfg["training"]["epochs"] = 2
    (tmp_path / "train2.yaml").write_text(yaml.safe_dump(train_cfg))
    r = _cli("train", tmp_path / "train2.yaml", "--device", "cpu", "--resume")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Resumed unet from" in r.stdout and "unet - Epoch 2/2" in r.stdout
    assert load_checkpoint(str(ckpts / "unet_last"))["meta"]["epoch"] == 2

    if not torch.cuda.is_available():
        for main, cfg in ((cli_train.main, "train.yaml"), (cli_evaluate.main, "eval.yaml")):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                main(["--config", str(tmp_path / cfg)])
