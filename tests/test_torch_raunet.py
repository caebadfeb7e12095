"""raunet in the port against the JAX package (CPU, float32): the model, its
pretrained ResNet-34 encoder and the msgpack reader that loads the vendored
encoder without ``msgpack``, ``flax`` or ``unet_zoo_tpu``.

Held against JAX: eval logits with one class and with two (log-softmax),
one ``make_train_step`` (``test_torch_core_members.check_train_step``), the
encoder ``create_model`` overlays (the vendored file, a torchvision-named
``.pth`` through ``weights_path`` or ``$UNET_ZOO_RESNET34``) against JAX's
overlaid encoder, bit for bit, and the reader against
``flax.serialization.msgpack_restore`` leaf by leaf.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import test_torch_core_members as core
from test_torch_core_members import _nchw, _nhwc, _rel
from unet_zoo_tpu.models import VENDORED_RAUNET_ENCODER as JAX_VENDORED
from unet_zoo_tpu.models import create_model as jax_create_model
from unet_zoo_tpu.utils.convert import convert_state_dict
from unet_zoo_tpu_torch import create_model
from unet_zoo_tpu_torch.utils import pretrained
from unet_zoo_tpu_torch.utils.convert import from_jax_variables

torch.set_num_threads(1)

ENCODER_PREFIXES = ("firstconv.", "firstbn.", "encoder")


def encoder_of(sd):
    return {k: v for k, v in sd.items() if k.startswith(ENCODER_PREFIXES)
            and not k.endswith("num_batches_tracked")}


# --- the msgpack reader --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def vendored_bytes():
    with open(pretrained.VENDORED_RAUNET_ENCODER, "rb") as f:
        return f.read()


def test_vendored_path_is_jax_vendored_file():
    assert os.path.samefile(pretrained.VENDORED_RAUNET_ENCODER, JAX_VENDORED)


def test_reader_matches_flax_on_the_vendored_encoder():
    """Every leaf of the vendored file bit for bit, with its dtype (108
    float16 parameters, 72 float32 statistics) and the tree's structure and
    meta strs."""
    data = vendored_bytes()
    got, want = pretrained.msgpack_restore(data), serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    arrays = 0
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves_with_path(want)):
        assert pa == pb and type(a) is type(b), pa
        if isinstance(a, np.ndarray):
            arrays += 1
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), pa
        else:
            assert a == b, pa
    assert arrays == 180
    dtypes = [a.dtype for a in jax.tree_util.tree_leaves(got) if isinstance(a, np.ndarray)]
    assert dtypes.count(np.float16) == 108 and dtypes.count(np.float32) == 72
    assert got["meta"] == want["meta"] and all(isinstance(v, str) for v in got["meta"].values())


def _objects():
    """Objects whose packing takes every form the reader decodes: the int
    forms at their edges, nil, bools, str/bin/array/map at fix, 8/16 and
    32-bit lengths, and flax ndarrays whose payloads take fixext16 and
    ext8/16/32."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    yield "ints", {"v": ints}
    yield "nil and bools", {"a": None, "b": True, "c": False, "d": [None, True]}
    for n in (5, 40, 300, 70000):
        yield f"str {n}", {"s": "x" * n, "k" * n: 1}
        yield f"bin {n}", {"b": bytes(range(256)) * (n // 256) + bytes(n % 256)}
        yield f"array {n}", {"a": list(range(min(n, 70000)))}
    yield "map16 and map32", {"m16": {str(i): i for i in range(20)},
                              "m32": {str(i): i for i in range(70000)}}
    rng = np.random.default_rng(0)
    for shape, dtype in (((5,), np.uint8), ((1,), np.float32), ((3, 4), np.float16),
                         ((7, 9, 3), np.float32), ((100, 700), np.float16),
                         ((300, 300), np.float32)):
        yield f"ndarray {shape} {np.dtype(dtype).name}", {
            "x": {"y": (rng.standard_normal(shape) * 100).astype(dtype)}}


OBJECTS = dict(_objects())


@pytest.mark.parametrize("key", sorted(OBJECTS))
def test_reader_decodes_every_form(key):
    """What flax writes, read as flax reads it."""
    data = serialization.msgpack_serialize(OBJECTS[key])
    got, want = pretrained.msgpack_restore(data), serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        else:
            assert type(a) is type(b) and a == b


def test_ndarray_payloads_take_every_ext_form():
    """The arrays above are packed as fixext16, ext8, ext16 and ext32."""
    heads = set()
    for key, obj in OBJECTS.items():
        if key.startswith("ndarray"):
            data = serialization.msgpack_serialize(obj)
            heads.add(data[data.index(b"y") + 1])
    assert {0xD8, 0xC7, 0xC8, 0xC9} <= heads, sorted(map(hex, heads))


@pytest.mark.parametrize("data,match", [
    (msgpack.packb({"a": 1.5}), "type byte 0xcb"),
    (msgpack.packb([1, 2.5]), "type byte 0xcb"),
    (msgpack.packb(msgpack.ExtType(2, b"\x93\x91\x01\xa9complex64\xc4\x08" + bytes(8))),
     "ext code 2"),
    (serialization.msgpack_serialize({"a": np.float32(2.0)}), "ext code 3"),
    (msgpack.packb({"a": 1}) + b"\x00", "1 bytes after"),
    (msgpack.packb({"a": "xyz"})[:-1], "bytes wanted"),
    (bytes([0xC1]), "type byte 0xc1"),
])
def test_reader_raises_on_what_it_does_not_take(data, match):
    with pytest.raises(ValueError, match=match):
        pretrained.msgpack_restore(data)


# --- the pretrained encoder -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_overlaid_encoder(weights_path=None):
    """JAX's create_model('raunet') variables after its init overlay (32px
    sample), the encoder as port keys."""
    m = jax_create_model("raunet", weights_path=weights_path)
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    enc = from_jax_variables("raunet_encoder", {"params": v["params"]["encoder"],
                                                "batch_stats": v["batch_stats"]["encoder"]})
    return encoder_of(enc)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], t), k


def test_create_model_overlays_the_vendored_encoder(capsys):
    """The port's raunet carries JAX's overlaid encoder, every parameter and
    running statistic bit for bit (float16 parameters cast to float32); the
    decoder keeps its seeded draw."""
    port = create_model("raunet", device="cpu", seed=5)
    assert "vendored synthetic-pretrained encoder" in capsys.readouterr().out
    sd = port.module.state_dict()
    _assert_same(encoder_of(sd), jax_overlaid_encoder())
    fresh = create_model("raunet", device="cpu", seed=5, pretrained=False).module.state_dict()
    assert torch.equal(sd["decoder4.conv1.weight"], fresh["decoder4.conv1.weight"])
    assert not torch.equal(sd["firstconv.weight"], fresh["firstconv.weight"])


def test_overlay_needs_no_jax_flax_or_msgpack():
    """In a fresh interpreter create_model('raunet') loads the vendored
    encoder with neither ``msgpack``, ``flax`` nor ``unet_zoo_tpu`` imported."""
    code = ("import sys\n"
            "from unet_zoo_tpu_torch import create_model\n"
            "m = create_model('raunet', device='cpu')\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('msgpack', 'flax', "
            "'unet_zoo_tpu')]\n"
            "assert not bad, bad\n"
            "print(float(m.module.firstconv.weight.double().sum()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         env={**os.environ, "UNET_ZOO_RESNET34": ""}, timeout=120)
    assert out.returncode == 0, out.stderr
    want = float(jax_overlaid_encoder()["firstconv.weight"].double().sum())
    assert float(out.stdout.strip().splitlines()[-1]) == want


def torchvision_state_dict(seed=7):
    """A torchvision resnet34 state_dict (its key layout, the classifier head
    included) of seeded values at the port encoder's shapes."""
    shapes = {k: v.shape for k, v in encoder_of(
        create_model("raunet", device="cpu", pretrained=False).module.state_dict()).items()}
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in shapes.items():
        k = k.replace("firstconv.", "conv1.").replace("firstbn.", "bn1.")
        k = k.replace("encoder", "layer", 1) if k.startswith("encoder") else k
        value = torch.rand(shape, generator=g) + 0.5 if k.endswith("running_var") else \
            torch.randn(shape, generator=g) * 0.05
        sd[k] = value
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, 512, generator=g), torch.zeros(1000)
    return sd


@pytest.mark.parametrize("prefixed", [False, True])
def test_weights_path_loads_a_torchvision_pth(tmp_path, prefixed):
    """``weights_path`` to a torchvision-named ``.pth`` (``module.``
    prefixes, as a DataParallel save writes, stripped): the port's encoder is
    the file's, and equals JAX's encoder from the same file."""
    sd = torchvision_state_dict()
    path = tmp_path / "resnet34.pth"
    torch.save({f"module.{k}" if prefixed else k: v for k, v in sd.items()}, path)
    port = create_model("raunet", device="cpu", weights_path=str(path))
    got = encoder_of(port.module.state_dict())
    assert torch.equal(got["firstconv.weight"], sd["conv1.weight"])
    assert torch.equal(got["encoder3.0.downsample.1.running_var"],
                       sd["layer3.0.downsample.1.running_var"])
    _assert_same(got, jax_overlaid_encoder(str(path)))


def test_environment_variable_then_vendored_file(tmp_path, monkeypatch, capsys):
    """``$UNET_ZOO_RESNET34`` names the ``.pth`` when no path is given; one
    that does not exist is ignored with a warning, for the vendored file."""
    sd = torchvision_state_dict(seed=8)
    path = tmp_path / "env.pth"
    torch.save(sd, path)
    monkeypatch.setenv("UNET_ZOO_RESNET34", str(path))
    got = encoder_of(create_model("raunet", device="cpu").module.state_dict())
    assert torch.equal(got["encoder1.0.conv1.weight"], sd["layer1.0.conv1.weight"])
    monkeypatch.setenv("UNET_ZOO_RESNET34", str(tmp_path / "missing.pth"))
    got = encoder_of(create_model("raunet", device="cpu").module.state_dict())
    assert "does not exist; ignoring" in capsys.readouterr().out
    _assert_same(got, jax_overlaid_encoder())


def test_without_weights_warns_and_keeps_the_random_init(monkeypatch, capsys):
    """No file anywhere: a warning and the seeded random init, as JAX's last
    resort; ``pretrained=False`` never overlays."""
    monkeypatch.delenv("UNET_ZOO_RESNET34", raising=False)
    monkeypatch.setattr(pretrained, "VENDORED_RAUNET_ENCODER", "/nonexistent/encoder.msgpack")
    got = create_model("raunet", device="cpu", seed=2).module.state_dict()
    assert "found no weights" in capsys.readouterr().out
    fresh = create_model("raunet", device="cpu", seed=2, pretrained=False).module.state_dict()
    for k, t in fresh.items():
        assert torch.equal(got[k], t), k


def test_overlay_refuses_a_wrong_encoder(tmp_path):
    sd = torchvision_state_dict()
    sd["conv1.weight"] = sd["conv1.weight"][:32]
    path = tmp_path / "bad.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError, match="firstconv.weight shape"):
        create_model("raunet", device="cpu", weights_path=str(path))
    del sd["layer4.2.bn2.bias"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="missing"):
        create_model("raunet", device="cpu", weights_path=str(path))


# --- the model ----------------------------------------------------------------------------


MEMBERS = {"raunet": ("raunet", 64, {}), "raunet_2": ("raunet", 64, {"num_classes": 2})}


@functools.lru_cache(maxsize=None)
def member(key):
    """As ``test_torch_core_members.build_member``, with raunet's variables
    drawn (its init overlay aside: every leaf seeded) and classes kept."""
    name, size, kw = MEMBERS[key]
    m, v = core.jax_variables(name, size, **kw)
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    apply = jax.jit(lambda v_, x_: m.module.apply(v_, x_, train=False))
    want = {k: np.asarray(o) for k, o in apply(v, jnp.asarray(x)).items()}
    return dict(name=name, kw=kw, m=m, v=v, x=x, apply=apply, want=want)


@pytest.mark.parametrize("key", sorted(MEMBERS))
def test_forward_matches_jax(key):
    """Eval logits within 1e-3 rel L2 of JAX's at the input's size (the
    head's 2n + 1, - 2, + 1); with two classes log-probabilities."""
    c = member(key)
    port = core.port_model(c["name"], c["v"], **c["kw"])
    with torch.no_grad():
        got = _nhwc(port.module(_nchw(c["x"]))["main"])
    want = c["want"]["main"]
    assert got.shape == want.shape == (2, 64, 64, c["kw"].get("num_classes", 1))
    assert _rel(got, want) <= 1e-3, _rel(got, want)
    if c["kw"].get("num_classes", 1) > 1:
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)


def test_converter_inverts_jax_converter():
    """from_jax_variables inverts ``convert_raunet`` (the original zoo's
    names, the LayerNorms' [C, 1, 1] and both transposed convs' flips)
    exactly, both ways."""
    port = create_model("raunet", device="cpu", seed=3, pretrained=False)
    sd = port.module.state_dict()
    v = convert_state_dict("raunet", dict(sd))
    back = from_jax_variables("raunet", v)
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k].to(t.dtype), t), k
    jax.tree_util.tree_map(np.testing.assert_array_equal, convert_state_dict("raunet", back), v)


def test_raunet_requires_three_channels():
    with pytest.raises(ValueError, match="in_channels == 3"):
        create_model("raunet", device="cpu", in_channels=1, pretrained=False)


def test_train_step_matches_jax():
    """One step from the same variables and batch. Train-mode BatchNorm runs
    down to the 2 x 2 of stride 32 (8 values a channel at B=2) and every
    decoder level doubles the rounding of the level below: the train-mode
    logits lie 1.3e-4 (port) and 1.8e-4 (JAX) rel L2 from a float64 run of
    the port at 64px (1.3e-4 and 3.1e-4 at 128px), and the losses 9e-5
    apart. So loss and Dice are held to JAX's at 3e-4, and the gradients and
    statistics in two parts against a float64 copy (``check_train_step``)."""
    core.check_train_step(member("raunet"), conditioned=True, loss_rtol=3e-4)
