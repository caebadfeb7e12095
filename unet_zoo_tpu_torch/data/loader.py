"""Host batching loader and device prefetch.

Counterpart of ``unet_zoo_tpu/data/loader.py`` (``DataLoader``,
``prefetch_to_device``) and of ``create_loader`` in
``unet_zoo_tpu/data/grain_loader.py``. The loader is a
``torch.utils.data.DataLoader`` driven by :class:`EpochBatchSampler`,
which yields the JAX loader's batches index for index: each iteration
shuffles with ``np.random.default_rng(seed + epoch)``, and ``drop_last``
and ``len`` agree. A new loader starts again at epoch 0, as the JAX one does
(so a resumed run sees the first epoch's order again).

A batch is ``(images, masks, paths)``: the items stacked NHWC and returned
as ``permute(0, 3, 1, 2)``, an NCHW view in ``channels_last`` strides (the
models' memory format) at no copy. ``num_workers`` > 1 decodes in that many
worker processes (spawned, kept across epochs); otherwise items load in the
calling process. ``pin_memory`` pins each batch for an asynchronous copy
to a CUDA device (:func:`prefetch_to_device`).
"""

from __future__ import annotations

import collections
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

Batch = Tuple[torch.Tensor, torch.Tensor, tuple]


class EpochBatchSampler(torch.utils.data.Sampler):
    """Batches of dataset indices; shuffled per iteration from
    ``np.random.default_rng(seed + epoch)``, the epoch counting iterations.

    ``shard`` = (rank, world, microbatches) makes each batch a global batch
    of which only rank ``rank``'s rows are yielded
    (``parallel.multihost.batch_rows``), so that a rank loads no other
    rank's items; a global batch that does not divide over the ranks raises
    ValueError, as JAX's ``device_put`` of it onto the batch sharding does."""

    def __init__(self, length: int, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.length = length
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.shard: Optional[Tuple[int, int, int]] = None

    def __len__(self) -> int:
        if self.drop_last:
            return self.length // self.batch_size
        return (self.length + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(self.length)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        for b in range(len(self)):
            batch = idx[b * self.batch_size:(b + 1) * self.batch_size]
            if self.shard is not None:
                from unet_zoo_tpu_torch.parallel.multihost import batch_rows

                rank, world, microbatches = self.shard
                batch = batch[batch_rows(len(batch), microbatches, rank, world).numpy()]
            yield [int(i) for i in batch]


def collate_nchw(items) -> Batch:
    """Stack NHWC items; return NCHW views (``channels_last`` strides)."""
    images = torch.from_numpy(np.stack([it[0] for it in items]))
    masks = torch.from_numpy(np.stack([it[1] for it in items]))
    return images.permute(0, 3, 1, 2), masks.permute(0, 3, 1, 2), tuple(it[2] for it in items)


def _reseed_worker(worker_id: int) -> None:
    """Give each worker's copy of the dataset its own flip stream (the JAX
    loader's process workers reseed theirs the same way)."""
    info = torch.utils.data.get_worker_info()
    if getattr(info.dataset, "_aug_rng", None) is not None:
        info.dataset._aug_rng = np.random.default_rng([info.seed, 0x5EED])


class DataLoader:
    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = EpochBatchSampler(len(dataset), batch_size, shuffle, drop_last, seed)
        workers = num_workers if num_workers > 1 else 0
        self._loader = torch.utils.data.DataLoader(
            dataset, batch_sampler=self.sampler, collate_fn=collate_nchw,
            num_workers=workers, pin_memory=pin_memory, persistent_workers=workers > 0,
            multiprocessing_context="spawn" if workers else None,
            worker_init_fn=_reseed_worker if workers else None)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Batch]:
        return iter(self._loader)

    def close(self) -> None:
        """Stop the worker processes (also done when the loader is collected)."""
        it = getattr(self._loader, "_iterator", None)
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()
        self._loader._iterator = None


def prefetch_to_device(iterator, size: int = 2, device=None, mesh=None, microbatches: int = 1):
    """Copy batches (images and masks) to ``device`` ``size`` batches ahead
    of the consumer, asynchronously where the host batch is pinned.

    With a ``mesh`` the iterator is a :class:`DataLoader` whose batches are
    global batches: it loads only this rank's rows of each
    (``EpochBatchSampler.shard``, for a step of ``microbatches``
    microbatches), in the loader's order, and they go to the mesh's device.
    A batch that does not divide over the data axis (a last validation batch
    without ``drop_last``) raises ValueError, as JAX's ``device_put`` of it
    onto the batch sharding does."""
    queue = collections.deque()
    if isinstance(iterator, DataLoader):
        iterator.sampler.shard = None
    if mesh is not None:
        from unet_zoo_tpu_torch.parallel.mesh import data_group_of, mesh_device

        if not isinstance(iterator, DataLoader):
            raise TypeError("prefetch_to_device(mesh=...) takes a DataLoader, whose sampler "
                            f"loads this rank's rows, not a {type(iterator).__name__}")
        group = data_group_of(mesh)
        iterator.sampler.shard = (torch.distributed.get_rank(group),
                                  torch.distributed.get_world_size(group), microbatches)
        device = mesh_device(mesh)

    def _put(batch):
        imgs, masks, paths = batch
        if device is not None:
            imgs = imgs.to(device, non_blocking=True)
            masks = masks.to(device, non_blocking=True)
        queue.append((imgs, masks, paths))

    it = iter(iterator)
    try:
        for _ in range(size):
            _put(next(it))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            _put(next(it))
        except StopIteration:
            pass
        yield out


def create_loader(dataset, batch_size: int = 4, shuffle: bool = False,
                  drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                  backend: str = "native", pin_memory: bool = False) -> DataLoader:
    """Loader factory: ``backend`` 'native' (:class:`DataLoader`); 'grain'
    raises (ROADMAP Queue 1 item 11)."""
    if backend == "grain":
        raise NotImplementedError("loader backend 'grain' is not ported (ROADMAP Queue 1 "
                                  "item 11); use data.loader: native")
    if backend != "native":
        raise ValueError(f"unknown loader backend: {backend!r} "
                         "(expected 'native' or 'grain')")
    return DataLoader(dataset, batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed,
                      num_workers=num_workers, pin_memory=pin_memory)
