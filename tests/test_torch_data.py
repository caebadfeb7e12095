"""The port's input pipeline against the JAX package (CPU): BoneDataset on
PNGs (both transfer types, host flips), SyntheticDataset, the loader's
batches over epochs, device prefetch, the dataset check, and the flips on
the device inside the train step."""

import numpy as np
import pytest
import torch

from test_torch_train import _Tiny
from unet_zoo_tpu.data import BoneDataset as JaxBone
from unet_zoo_tpu.data import SyntheticDataset as JaxSynthetic
from unet_zoo_tpu.data.loader import DataLoader as JaxLoader
from unet_zoo_tpu.train.metrics import check_dataset_integrity as jax_check
from unet_zoo_tpu.utils.logger import Logger as JaxLogger
from unet_zoo_tpu_torch.data import (
    BoneDataset,
    DataLoader,
    SyntheticDataset,
    create_loader,
    prefetch_to_device,
    prepare_images,
    prepare_masks,
)
from unet_zoo_tpu_torch.data.augment import random_flips, step_generator
from unet_zoo_tpu_torch.models import _REGISTRY, ZooModel
from unet_zoo_tpu_torch.train import create_train_state, make_train_step
from unet_zoo_tpu_torch.train.metrics import check_dataset_integrity
from unet_zoo_tpu_torch.utils.logger import Logger

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """train/valid PNG pairs of 40x40 (resized to 32 by the datasets), masks
    with soft edges so that the threshold matters, one JPEG image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    for split, n in (("train", 5), ("valid", 2)):
        (root / split / "images").mkdir(parents=True)
        (root / split / "masks").mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
            ext = "jpg" if i == 3 else "png"
            Image.fromarray(img).save(root / split / "images" / f"{i:02d}.{ext}")
            m = np.zeros((40, 40), np.uint8)
            m[6 + i:30, 4:26 + i] = 255
            m[20:24, :] = 128
            Image.fromarray(m).save(root / split / "masks" / f"{i:02d}.png")
        (root / split / "images" / ".hidden.png").write_bytes(b"")
    return str(root)


def _assert_items_equal(got, want):
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
def test_bone_dataset_matches_jax(png_root, transfer_dtype, augment, cache):
    """Items equal JAX's BoneDataset(decoder="pil") exactly, over two passes
    (host flips from one seed, drawn in the same order)."""
    kw = dict(image_size=32, cache=cache, augment=augment, seed=7, transfer_dtype=transfer_dtype)
    want_ds = JaxBone(png_root, "train", decoder="pil", **kw)
    got_ds = BoneDataset(png_root, "train", decoder="pil", **kw)
    assert len(got_ds) == len(want_ds) == 5
    for _ in range(2):
        for i in range(len(got_ds)):
            _assert_items_equal(got_ds[i], want_ds[i])


def test_bone_dataset_decoders(png_root):
    """'auto' decodes with PIL; 'cpp' raises naming the ROADMAP item; other
    names and a missing split raise as in JAX."""
    auto, pil = (BoneDataset(png_root, "valid", image_size=32, decoder=d) for d in ("auto", "pil"))
    for i in range(len(pil)):
        _assert_items_equal(auto[i], pil[i])
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        BoneDataset(png_root, "valid", decoder="cpp")
    with pytest.raises(ValueError, match="decoder"):
        BoneDataset(png_root, "valid", decoder="opencv")
    with pytest.raises(FileNotFoundError):
        BoneDataset(png_root, "test")


@pytest.mark.parametrize("seed,channels", [(0, 3), (3, 1)])
def test_synthetic_dataset_matches_jax(seed, channels):
    want, got = JaxSynthetic(5, 24, channels, seed), SyntheticDataset(5, 24, channels, seed)
    assert len(got) == len(want)
    for i in range(5):
        _assert_items_equal(got[i], want[i])


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(drop_last):
    """Three epochs with shuffle on: the port's batches are JAX's DataLoader
    batches, transposed to NCHW views in channels_last strides (no copy), in
    the same order; len agrees."""
    kw = dict(batch_size=4, shuffle=True, drop_last=drop_last, seed=5)
    want = JaxLoader(JaxSynthetic(10, 8, seed=2), num_workers=1, **kw)
    got = DataLoader(SyntheticDataset(10, 8, seed=2), num_workers=0, **kw)
    assert len(got) == len(want) == (2 if drop_last else 3)
    orders = []
    for _ in range(3):
        wb, gb = list(want), list(got)
        assert len(gb) == len(wb)
        for (wi, wm, wp), (gi, gm, gp) in zip(wb, gb):
            assert gp == wp
            assert gi.shape == (wi.shape[0], 3, 8, 8) and gm.shape == (wi.shape[0], 1, 8, 8)
            assert gi.is_contiguous(memory_format=torch.channels_last)
            assert _nhwc(gi).flags["C_CONTIGUOUS"]     # a view of the stacked items
            np.testing.assert_array_equal(_nhwc(gi), wi)
            np.testing.assert_array_equal(_nhwc(gm), wm)
        orders.append([p for b in gb for p in b[2]])
    assert orders[0] != orders[1]
    want.close()
    got.close()


def test_loader_uint8_and_unshuffled(png_root):
    """uint8 BoneDataset batches pass as uint8; without shuffle every epoch
    is in index order, the last batch short."""
    ds = BoneDataset(png_root, "train", image_size=32, transfer_dtype="uint8")
    want = JaxLoader(JaxBone(png_root, "train", image_size=32, transfer_dtype="uint8",
                             decoder="pil"), batch_size=2, num_workers=1)
    got = create_loader(ds, batch_size=2, num_workers=0)
    for _ in range(2):
        batches = list(got)
        assert [b[0].shape[0] for b in batches] == [2, 2, 1]
        for (wi, wm, wp), (gi, gm, gp) in zip(want, batches):
            assert gi.dtype == torch.uint8 and gm.dtype == torch.uint8 and gp == wp
            np.testing.assert_array_equal(_nhwc(gi), wi)
            np.testing.assert_array_equal(_nhwc(gm), wm)
    want.close()


def test_loader_worker_processes_give_the_same_batches():
    """num_workers 2: spawned worker processes, the same batches as loading
    in the calling process, over two epochs."""
    kw = dict(batch_size=3, shuffle=True, drop_last=False, seed=1)
    local = DataLoader(SyntheticDataset(8, 8), num_workers=0, **kw)
    pooled = DataLoader(SyntheticDataset(8, 8), num_workers=2, **kw)
    try:
        for _ in range(2):
            for (li, lm, lp), (pi, pm, pp) in zip(local, pooled):
                assert tuple(pp) == lp
                assert torch.equal(pi, li) and torch.equal(pm, lm)
    finally:
        pooled.close()


def test_create_loader_backends():
    ds = SyntheticDataset(4, 8)
    assert isinstance(create_loader(ds, 2, num_workers=0), DataLoader)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        create_loader(ds, 2, backend="grain")
    with pytest.raises(ValueError, match="unknown loader backend"):
        create_loader(ds, 2, backend="tfdata")


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_to_device_keeps_batches(size):
    """Every batch once, in order, on the target device."""
    batches = list(DataLoader(SyntheticDataset(7, 8), 2, num_workers=0))
    for device in (None, "cpu"):
        out = list(prefetch_to_device(iter(batches), size=size, device=device))
        assert len(out) == len(batches)
        for (a, am, ap), (b, bm, bp) in zip(out, batches):
            assert ap == bp and torch.equal(a, b) and torch.equal(am, bm)
            assert a.device.type == "cpu"


def test_check_dataset_integrity_matches_jax(png_root, tmp_path, capsys):
    with JaxLogger(str(tmp_path / "jax.txt")) as log:
        jax_check(png_root, log)
    want = capsys.readouterr().out
    with Logger(str(tmp_path / "port.txt")) as log:
        check_dataset_integrity(png_root, log)
    got = capsys.readouterr().out
    assert got == want and ".png: unique values = [  0 128 255], shape = (40, 40)" in got


# --- flips on the device ------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 17])
def test_random_flips_match_numpy(step):
    """random_flips against numpy flips of the same draws (the generator of
    ``step``), image and mask alike; another step draws other flips."""
    rng = np.random.default_rng(step)
    images = rng.standard_normal((8, 3, 6, 5)).astype(np.float32)
    masks = (rng.random((8, 1, 6, 5)) > 0.5).astype(np.float32)
    draws = torch.rand(2, 8, generator=step_generator(step, "cpu")).numpy()
    want_i, want_m = images.copy(), masks.copy()
    for b in range(8):
        if draws[0, b] < 0.5:
            want_i[b], want_m[b] = want_i[b][:, :, ::-1], want_m[b][:, :, ::-1]
        if draws[1, b] < 0.5:
            want_i[b], want_m[b] = want_i[b][:, ::-1], want_m[b][:, ::-1]
    gi, gm = random_flips(step_generator(step, "cpu"), torch.from_numpy(images),
                          torch.from_numpy(masks))
    np.testing.assert_array_equal(gi.numpy(), want_i)
    np.testing.assert_array_equal(gm.numpy(), want_m)
    other = torch.rand(2, 8, generator=step_generator(step + 1, "cpu")).numpy()
    assert not np.array_equal(other < 0.5, draws < 0.5)


def _tiny():
    torch.manual_seed(0)
    return ZooModel(name="unet", module=_Tiny(), spec=_REGISTRY["unet"], in_channels=3,
                    num_classes=1, image_size=None)


def test_train_step_augment_flips_by_step_count():
    """make_train_step(augment=True) at step counts 0, 1, 2 equals the plain
    step on the batch flipped by the generator of that count (loss, Dice
    and weights bit for bit); a state started at another count draws other
    flips."""
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (4, 3, 8, 8), dtype=np.uint8))
    masks = torch.from_numpy((rng.random((4, 1, 8, 8)) > 0.5).astype(np.uint8))
    aug, plain = _tiny(), _tiny()
    sa, sp = create_train_state(aug, 1e-2), create_train_state(plain, 1e-2)
    step_a, step_p = make_train_step(aug, augment=True), make_train_step(plain)
    for s in range(3):
        fi, fm = random_flips(step_generator(s, "cpu"), prepare_images(images),
                              prepare_masks(masks))
        got, want = step_a(sa, images, masks), step_p(sp, fi, fm)
        assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["dice"], want["dice"])
    for k, v in aug.module.state_dict().items():
        assert torch.equal(v, plain.module.state_dict()[k]), k
    late = _tiny()
    sl = create_train_state(late, 1e-2)
    sl.step = 5
    first = _tiny()
    assert not torch.equal(make_train_step(late, augment=True)(sl, images, masks)["loss"],
                           make_train_step(first, augment=True)(
                               create_train_state(first, 1e-2), images, masks)["loss"])
