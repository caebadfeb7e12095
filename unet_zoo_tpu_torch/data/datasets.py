"""Paired image/mask datasets (NHWC numpy items on the host) and batch
preparation on the device (NCHW).

Counterpart of ``unet_zoo_tpu/data/datasets.py``. The items are the JAX
package's, value for value: an HWC image and an HW1 mask, as float32
(normalised on the host) or uint8 (raw pixels, {0, 1} masks; the ImageNet
normalisation then runs on the device, in float32, as
``(x / 255 - mean) / std``), with host-side flips drawn from
``np.random.default_rng(seed)`` in the same order. The loader
(``data/loader.py``) hands the model NCHW views of them. Decoding is PIL's;
the JAX package's C++ decode pipeline is not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_MEAN, _STD = np.asarray(IMAGENET_MEAN, np.float32), np.asarray(IMAGENET_STD, np.float32)

_VALID_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tiff", ".bmp")


def _normalize(img: np.ndarray) -> np.ndarray:
    return (img - _MEAN) / _STD


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """Normalise a uint8 [B, 3, H, W] batch to float32; other types pass."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    x = images.float() / 255.0
    return (x - mean.view(1, -1, 1, 1)) / std.view(1, -1, 1, 1)


def prepare_masks(masks: torch.Tensor) -> torch.Tensor:
    """uint8 {0, 1} masks -> float32; other types pass."""
    return masks.float() if masks.dtype == torch.uint8 else masks


class BoneDataset:
    """Paired ``{split}/{images,masks}`` dataset.

    Returns ``(image [S, S, 3] float32 normalised, mask [S, S, 1] float32
    binary, path)`` per item, or a raw ``uint8`` image and a ``{0, 1}``
    ``uint8`` mask with ``transfer_dtype="uint8"``. Files are listed sorted
    and filtered by extension; masks are binarised at 0.5 (``> 127`` for
    uint8). ``augment`` flips image and mask together, horizontally and
    then vertically, each with probability 0.5. ``decoder`` ``"auto"`` and
    ``"pil"`` decode with PIL; ``"cpp"`` raises (ROADMAP Queue 1 item 11).
    """

    def __init__(self, root_path: str, split: str = "train",
                 limit: Optional[int] = None, image_size: int = 512,
                 cache: bool = False, augment: bool = False, seed: int = 0,
                 transfer_dtype: str = "float32", decoder: str = "auto"):
        self.root_path = root_path
        self.split = split
        self.limit = limit
        self.image_size = image_size
        self.cache = cache
        self._cache: dict = {}
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype must be float32|uint8, "
                             f"got {transfer_dtype!r}")
        self.transfer_dtype = transfer_dtype
        self.augment = augment
        self._aug_rng = np.random.default_rng(seed)
        if decoder not in ("auto", "pil", "cpp"):
            raise ValueError(f"decoder must be auto|pil|cpp, got {decoder!r}")
        if decoder == "cpp":
            raise NotImplementedError("decoder='cpp' (the C++ decode pipeline) is not ported "
                                      "yet (ROADMAP Queue 1 item 11); use 'pil' or 'auto'")
        self.decoder = decoder

        images_path = os.path.join(root_path, split, "images")
        masks_path = os.path.join(root_path, split, "masks")
        if not os.path.exists(images_path):
            raise FileNotFoundError(f"Image directory not found: {images_path}")
        if not os.path.exists(masks_path):
            raise FileNotFoundError(f"Mask directory not found: {masks_path}")

        image_files = sorted(
            f for f in os.listdir(images_path)
            if not f.startswith(".") and f.lower().endswith(_VALID_EXTENSIONS)
        )
        mask_files = sorted(
            f for f in os.listdir(masks_path)
            if not f.startswith(".") and f.lower().endswith(_VALID_EXTENSIONS)
        )
        self.images = [os.path.join(images_path, f) for f in image_files][: self.limit]
        self.masks = [os.path.join(masks_path, f) for f in mask_files][: self.limit]
        if len(self.images) != len(self.masks):
            print(
                f"Warning: Number of images ({len(self.images)}) doesn't match "
                f"number of masks ({len(self.masks)}) for split '{split}'."
            )

    def __len__(self) -> int:
        return len(self.images)

    def _augment(self, img: np.ndarray, mask: np.ndarray):
        if self._aug_rng.random() < 0.5:
            img, mask = img[:, ::-1].copy(), mask[:, ::-1].copy()
        if self._aug_rng.random() < 0.5:
            img, mask = img[::-1].copy(), mask[::-1].copy()
        return img, mask

    def _decode_pair(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(image uint8 [S, S, 3], mask uint8 [S, S]), resized bilinearly by PIL."""
        from PIL import Image  # only on-disk data needs PIL

        size = (self.image_size, self.image_size)
        img = Image.open(self.images[index]).convert("RGB").resize(size, Image.BILINEAR)
        mask = Image.open(self.masks[index]).convert("L").resize(size, Image.BILINEAR)
        return np.asarray(img, np.uint8), np.asarray(mask, np.uint8)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, str]:
        if self.cache and index in self._cache:
            img_np, mask_np = self._cache[index]
            if self.augment:
                img_np, mask_np = self._augment(img_np, mask_np)
            return img_np, mask_np, self.images[index]

        img_u8, mask_u8 = self._decode_pair(index)
        if self.transfer_dtype == "uint8":
            img_np = img_u8
            # v / 255 > 0.5 <=> v > 127: the float32 path's split
            mask_np = (mask_u8 > 127).astype(np.uint8)
        else:
            img_np = _normalize(img_u8.astype(np.float32) / 255.0)
            mask_np = (mask_u8.astype(np.float32) / 255.0 > 0.5
                       ).astype(np.float32)
        mask_np = mask_np[..., None]
        if self.cache:
            self._cache[index] = (img_np, mask_np)
        if self.augment:
            img_np, mask_np = self._augment(img_np, mask_np)
        return img_np, mask_np, self.images[index]


class SyntheticDataset:
    """Deterministic synthetic blobs and masks, for tests and runs without
    data on disk: float32 noise plus 2 inside a circular blob mask."""

    def __init__(self, length: int = 64, image_size: int = 256,
                 in_channels: int = 3, seed: int = 0):
        self.length = length
        self.image_size = image_size
        self.in_channels = in_channels
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray, str]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        s = self.image_size
        img = rng.standard_normal((s, s, self.in_channels)).astype(np.float32)
        cy, cx = rng.integers(s // 4, 3 * s // 4, size=2)
        r = rng.integers(s // 8, s // 4)
        yy, xx = np.mgrid[:s, :s]
        mask = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.float32)
        img = img + 2.0 * mask[..., None]  # signal correlated with the mask
        return img, mask[..., None], f"synthetic://{index}"
