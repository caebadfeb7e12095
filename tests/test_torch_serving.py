"""The port's serving surface beyond ``make_predictor`` against the JAX package
(CPU): the sliding-window predictor, the exported predictor and the two
serving CLIs.

* ``make_tiled_predictor`` against JAX's on the same converted ``unet``
  weights (a 50 x 70 image padded by reflection, a 12 x 14 one less than
  half the tile, padded from its edge), and on a pointwise stub, where the Hann
  blend must give the full-image output back;
* ``export_predictor``/``load_predictor``: a ``unet`` built with
  ``use_kernels=True`` exports K1 as its op four times (on the CPU the op
  runs K1's plain version), an int8 ``unet_tpu`` P2's conv as its op on
  every gated conv; the loaded program equals the live predictor bit for
  bit, also in a fresh process that imports only ``torch`` and
  ``unet_zoo_tpu_torch.ops.kernels``; a model whose forward reaches a kernel
  that is not an op yet (``mmunet``'s K4) refuses to export;
* ``python -m unet_zoo_tpu_torch.cli.predict`` (fixed size, ``--tiled``,
  ``--int8``, ``--tta``, ``--export``) and ``cli.export`` as subprocesses on
  ``--device cpu``.
"""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.utils import serving as jax_serving
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.models import ZooModel
from unet_zoo_tpu_torch.ops.kernels import fused_up as k1
from unet_zoo_tpu_torch.ops.kernels import int8_gemm as p2
from unet_zoo_tpu_torch.utils import serving
from unet_zoo_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- the tiled predictor ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def unet_pair():
    """The port's seed-0 ``unet`` and the JAX ``unet`` on the same weights
    (the JAX converter of the port's ``state_dict``)."""
    port = create_model("unet", device="cpu", seed=0)
    v = convert_state_dict("unet", dict(port.module.state_dict()))
    return port, jax_create_model("unet"), v


@pytest.mark.parametrize("shape,tile,overlap,tile_batch", [
    ((1, 50, 70), 32, 0.25, 4),     # 2 x 3 tiles, reflect padding, a short last chunk
    ((2, 12, 14), 32, 0.5, 8),      # one tile an image, over twice its size: edge padding
])
def test_tiled_matches_jax(shape, tile, overlap, tile_batch):
    """The tiled predictor's logits against JAX's ``make_tiled_predictor``
    on the same weights and image: the same grid, padding and Hann blend,
    so only the forwards' float32 rounding parts them (the forward bar,
    1e-3 rel L2); probabilities and masks follow."""
    port, model, v = unet_pair()
    b, h, w = shape
    x = np.random.default_rng(h * w).standard_normal((b, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_serving.make_tiled_predictor(
        model, v, tile=tile, overlap=overlap, tile_batch=tile_batch, cast_bf16=False)(
        jnp.asarray(x)))
    kw = dict(tile=tile, overlap=overlap, tile_batch=tile_batch, cast_bf16=False)
    got = _nhwc(serving.make_tiled_predictor(port, None, **kw)(_nchw(x)))
    assert got.shape == want.shape == (b, h, w, 1)
    assert _rel(got, want) <= 1e-3, _rel(got, want)
    probs = serving.make_tiled_predictor(port, None, output="probs", **kw)(_nchw(x))
    mask = serving.make_tiled_predictor(port, None, output="mask", **kw)(_nchw(x))
    assert probs.dtype == torch.float32 and mask.dtype == torch.uint8
    np.testing.assert_allclose(_nhwc(probs), 1 / (1 + np.exp(-got)), rtol=1e-5, atol=1e-6)
    assert torch.equal(mask, (probs > 0.5).to(torch.uint8))


class _Pointwise(nn.Module):
    """A pointwise model: ``(x * 2 + 1) @ k`` at every pixel, JAX's stub
    (``tests/test_serving.py::_PointwiseStub``)."""

    def __init__(self, k: np.ndarray):
        super().__init__()
        self.k = nn.Parameter(torch.from_numpy(k.T.copy()).reshape(2, 3, 1, 1))

    def forward(self, x):
        return {"main": F.conv2d(x * 2.0 + 1.0, self.k)}


def _stub():
    k = np.random.default_rng(1).standard_normal((3, 2)).astype(np.float32)
    return ZooModel(name="stub", module=_Pointwise(k), spec=None, in_channels=3,
                    num_classes=2, image_size=None), k


@pytest.mark.parametrize("tile,overlap,tile_batch", [(16, 0.25, 4), (16, 0.5, 3), (32, 0.0, 8),
                                                     (128, 0.25, 2)])
def test_tiled_pointwise_exact(tile, overlap, tile_batch):
    """On a pointwise model the Hann weights cancel: the tiled output equals
    the full-image one (JAX's bar, 2e-5), at 128 with one tile larger than
    the image; and equals JAX's tiled stub."""
    model, k = _stub()
    x = np.random.default_rng(2).standard_normal((2, 50, 70, 3)).astype(np.float32)
    full = (x * 2.0 + 1.0) @ k
    tiled = _nhwc(serving.make_tiled_predictor(model, None, tile=tile, overlap=overlap,
                                               tile_batch=tile_batch, cast_bf16=False)(_nchw(x)))
    np.testing.assert_allclose(tiled, full, rtol=2e-5, atol=2e-5)

    class JaxStub:
        class module:  # noqa: N801 - mimics ZooModel.module
            @staticmethod
            def apply(variables, x_, train=False):
                return {"main": (x_ * 2.0 + 1.0) @ variables["params"]["k"]}

    want = jax_serving.make_tiled_predictor(JaxStub(), {"params": {"k": jnp.asarray(k)}},
                                            tile=tile, overlap=overlap, tile_batch=tile_batch,
                                            cast_bf16=False)(jnp.asarray(x))
    np.testing.assert_allclose(tiled, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_tiled_geometry_and_window_match_jax():
    """tile_grid and hann_window are JAX's: n_h, n_w, the padded size, the
    pad mode (reflect, or edge where the pad is not smaller than the image),
    and the float64 window rounded once."""
    w1 = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(24) + 0.5) / 24)
    np.testing.assert_array_equal(serving.hann_window(24).numpy(),
                                  (np.outer(w1, w1) + 1e-6).astype(np.float32))
    assert serving.tile_grid(50, 70, 32, 24) == (2, 3, 56, 80, "reflect")
    assert serving.tile_grid(20, 24, 32, 16) == (1, 1, 32, 32, "reflect")
    assert serving.tile_grid(12, 14, 32, 16) == (1, 1, 32, 32, "replicate")
    assert serving.tile_grid(1024, 1024, 256, 192) == (5, 5, 1024, 1024, "reflect")
    assert serving.tile_grid(1100, 300, 256, 192) == (6, 2, 1216, 448, "reflect")
    with pytest.raises(ValueError, match="overlap"):
        serving.make_tiled_predictor(_stub()[0], None, overlap=1.0)


def test_tiled_matches_plain_predictor_when_tile_covers():
    """A tile that covers the image is the plain predictor's forward, and so
    are the logits (JAX's bar, 1e-4)."""
    port = unet_pair()[0]
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
    plain = serving.make_predictor(port, None, "logits", cast_bf16=False)(x)
    tiled = serving.make_tiled_predictor(port, None, tile=32, overlap=0.25,
                                         cast_bf16=False)(x)
    torch.testing.assert_close(tiled, plain.float(), rtol=1e-4, atol=1e-4)


def test_tiled_serves_int8_through_the_gated_convs(monkeypatch):
    """With ``quant`` every tile chunk runs the int8 convs (their wrapper, on
    the CPU the plain version): 17 launches a chunk of a narrow unet_tpu,
    the chunks all one shape (the last one filled up with copies)."""
    model = create_model("unet_tpu", device="cpu", widths=(16, 32, 32, 32))
    x = torch.randn(1, 3, 80, 48, generator=torch.Generator().manual_seed(5))
    stats = serving.calibrate_int8(model, [x[:, :, :32, :32]])
    shapes, kernel = [], p2.int8_conv3x3

    def counting(x_, *args):
        shapes.append(tuple(x_.shape[:3]))
        return kernel(x_, *args)

    monkeypatch.setattr(p2, "int8_conv3x3", counting)
    model.module.apply(lambda m: setattr(m, "use_kernels", True) if hasattr(m, "use_kernels")
                       else None)
    out = serving.make_tiled_predictor(model, None, tile=32, overlap=0.25, tile_batch=4,
                                       output="probs", quant=stats)(x)
    assert out.shape == (1, 1, 80, 48) and torch.isfinite(out).all()
    # 3 x 2 = 6 tiles, 2 chunks of 4
    assert len(shapes) == 2 * 17 and {s[0] for s in shapes} == {4}


# --- export and load ----------------------------------------------------------


def _op_count(program_module, op):
    return sum(str(n.target) == f"unet_zoo.{op}.default" for n in program_module.graph.nodes)


LOAD_SCRIPT = r"""
import sys
import torch
import unet_zoo_tpu_torch.ops.kernels  # registers the kernels' ops
torch.set_num_threads(1)
program = torch.export.load(sys.argv[1]).module()
x = torch.load(sys.argv[2])
with torch.inference_mode():
    torch.save(program(x), sys.argv[3])
print(sorted(m for m in sys.modules if m.startswith("unet_zoo_tpu_torch.models")))
"""


def test_export_round_trip_carries_k1(tmp_path):
    """unet with use_kernels=True (bf16-cast weights, probabilities, B=2,
    32px): the exported graph holds K1's op 4 times, one per decoder stage;
    the loaded program equals the live predictor bit for bit, in this
    process and in a fresh one that imports no model code, and launched K1
    once a stage (its wrapper counted on the CPU too)."""
    model = create_model("unet", device="cpu", seed=0, use_kernels=True)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(6))
    path = tmp_path / "unet.pt2"
    blob = serving.export_predictor(model, None, batch=2, image_size=32, output="probs",
                                    path=str(path))
    assert path.read_bytes() == blob
    live = serving.make_predictor(model, None, "probs")(x)
    loaded = serving.load_predictor(str(path))
    assert _op_count(loaded.module, "fused_up_concat_conv") == 4
    assert _op_count(loaded.module, "int8_conv") == 0
    calls, kernel = [], k1.fused_up_concat_conv
    k1.fused_up_concat_conv = lambda *a: calls.append(1) or kernel(*a)
    try:
        got = loaded(x)
    finally:
        k1.fused_up_concat_conv = kernel
    assert len(calls) == 4 and torch.equal(got, live)
    assert torch.equal(serving.load_predictor(blob)(x), live)
    torch.save(x, tmp_path / "x.pt")
    run = subprocess.run([sys.executable, "-c", LOAD_SCRIPT, str(path), str(tmp_path / "x.pt"),
                          str(tmp_path / "y.pt")], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().splitlines()[-1] == "[]"      # no model module imported
    assert torch.equal(torch.load(tmp_path / "y.pt"), live)


def test_export_int8_carries_p2():
    """An int8 unet_tpu (narrow, use_kernels=True, masks): the exported graph
    holds P2's conv op on each of its 17 gated convs, and the loaded program
    equals the live predictor bit for bit."""
    model = create_model("unet_tpu", device="cpu", widths=(16, 32, 32, 32), use_kernels=True)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(7))
    stats = serving.calibrate_int8(model, [x])
    blob = serving.export_predictor(model, None, batch=2, image_size=32, output="mask",
                                    quant=stats)
    loaded = serving.load_predictor(blob)
    assert _op_count(loaded.module, "int8_conv") == 17
    live = serving.make_predictor(model, None, "mask", quant=stats)(x)
    assert loaded(x).dtype == torch.uint8 and torch.equal(loaded(x), live)


def test_export_refuses_a_kernel_that_is_not_an_op():
    """mmunet's forward with use_kernels=True reaches K4, which is not an op
    yet: export raises naming it and the ROADMAP item rather than export
    the plain version in its place; with use_kernels=False the plain path
    exports, with no kernel op in it."""
    model = create_model("mmunet", device="cpu", base_channels=16, use_kernels=True)
    with pytest.raises(NotImplementedError, match=r"K4 \(fused_mkblock\).*item 14"):
        serving.export_predictor(model, None, batch=1, image_size=32)
    plain = create_model("mmunet", device="cpu", base_channels=16, use_kernels=False)
    loaded = serving.load_predictor(serving.export_predictor(plain, None, batch=1,
                                                             image_size=32))
    assert not any("unet_zoo" in str(n.target) for n in loaded.module.graph.nodes)
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(8))
    assert torch.equal(loaded(x), serving.make_predictor(plain, None, "logits")(x))


# --- the CLIs -----------------------------------------------------------------


CLI_PARAMS = '{"widths": [16, 32, 32, 32]}'


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A narrow unet_tpu checkpoint, a u2netp one (registry widths: the
    export CLI takes no model kwargs, as JAX's) and three PNGs of different
    sizes."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cli")
    model = create_model("unet_tpu", device="cpu", seed=1, widths=(16, 32, 32, 32))
    save_checkpoint(str(root / "ckpt"), {"variables": model.module.state_dict(), "step": 0})
    model = create_model("u2netp", device="cpu", seed=1)
    save_checkpoint(str(root / "u2netp"), {"variables": model.module.state_dict(), "step": 0})
    rng = np.random.default_rng(9)
    os.makedirs(root / "images")
    for i, (h, w) in enumerate([(40, 48), (33, 47), (64, 80)]):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "images" / f"{i:03d}.png")
    return root


def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", f"unet_zoo_tpu_torch.cli.{module}", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)


@pytest.mark.parametrize("mode", ["fixed", "tiled", "int8", "tta", "export"])
def test_predict_cli(cli_setup, mode):
    """cli.predict end to end on --device cpu: masks as PNGs at each input's
    size (fixed, --int8, --tta, with a short last batch), probabilities as
    .npy at each input's own resolution (--tiled), and --export's program
    loading and running at the fixed shape."""
    from PIL import Image

    out = cli_setup / f"out_{mode}"
    args = ["--model", "unet_tpu", "--checkpoint", str(cli_setup / "ckpt"), "--input",
            str(cli_setup / "images"), "--output", str(out), "--image-size", "32", "--batch",
            "2", "--params", CLI_PARAMS, "--device", "cpu"]
    extra = {"fixed": [], "tiled": ["--tiled", "--output-kind", "probs", "--overlap", "0.5"],
             "int8": ["--int8"], "tta": ["--tta", "--output-kind", "mask"],
             "export": ["--export", str(cli_setup / "unet_tpu.pt2")]}[mode]
    run = _cli("predict", *args, *extra)
    assert run.returncode == 0, run.stderr
    sizes = [(40, 48), (33, 47), (64, 80)]
    for i, (h, w) in enumerate(sizes):
        if mode == "tiled":
            arr = np.load(out / f"{i:03d}.npy")
            assert arr.shape == (h, w, 1) and np.all((arr >= 0) & (arr <= 1))
        else:
            img = np.asarray(Image.open(out / f"{i:03d}.png"))
            assert img.shape == (h, w) and set(np.unique(img)) <= {0, 255}
    if mode == "int8":
        assert "int8: calibrated on 1 batch" in run.stdout
    if mode == "export":
        predict = serving.load_predictor(str(cli_setup / "unet_tpu.pt2"))
        y = predict(torch.zeros(2, 3, 32, 32))
        assert y.shape == (2, 1, 32, 32) and y.dtype == torch.uint8


def test_predict_cli_refuses_tta_where_jax_does(cli_setup):
    for extra in (["--tta", "--tiled"], ["--tta", "--output-kind", "logits"]):
        run = _cli("predict", "--model", "unet_tpu", "--checkpoint", str(cli_setup / "ckpt"),
                   "--input", str(cli_setup / "images"), "--output", str(cli_setup / "no"),
                   "--image-size", "32", "--params", CLI_PARAMS, "--device", "cpu", *extra)
        assert run.returncode != 0 and "--tta averages probabilities" in run.stderr


def test_export_cli(cli_setup):
    """cli.export writes a u2netp program that load_predictor runs at its
    shape; the bf16-cast weights make it differ from a --no-bf16 export's
    logits but not by much."""
    outs = {}
    for flag in ([], ["--no-bf16"]):
        path = cli_setup / f"export{len(flag)}.pt2"
        run = _cli("export", "--model", "u2netp", "--checkpoint", str(cli_setup / "u2netp"),
                   "--batch", "2", "--image-size", "32", "--out", str(path), "--device",
                   "cpu", *flag)
        assert run.returncode == 0, run.stderr
        assert f"wrote {path}" in run.stdout
        x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(10))
        outs[len(flag)] = serving.load_predictor(str(path))(x).float()
    assert outs[0].shape == (2, 1, 32, 32)
    assert 0 < _rel(outs[0].numpy(), outs[1].numpy()) < 0.1
