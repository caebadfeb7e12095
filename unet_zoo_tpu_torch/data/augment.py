"""Random flips on the device, inside the train step. Counterpart of
``unet_zoo_tpu/data/augment.py``.

The draws come from a ``torch.Generator`` on the batch's device seeded
from the train step's count (:func:`step_generator`), as the JAX step keys
its flips off ``state.step``: a resumed run draws the same flips at the same
steps without saved generator state. The draws themselves are torch's, not
JAX's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# the stream of the flips' draws; step s draws from seed (FLIP_STREAM << 32) + s
FLIP_STREAM = 1


def step_generator(step: int, device) -> torch.Generator:
    """The generator of train step ``step``'s flips, on ``device``."""
    return torch.Generator(device=device).manual_seed((FLIP_STREAM << 32) + int(step))


def random_flips(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                 rows: Optional[torch.Tensor] = None, batch: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample flips of NCHW images and masks, the same for both: a
    horizontal flip (along W) where the first of two uniform draws per
    sample is below 0.5, then a vertical one (along H) where the second is,
    as the host-side ``BoneDataset`` augmentation flips.

    On a rank of a data-parallel step, ``images`` are the global batch's
    ``rows`` (of ``batch``): the draws are made for the whole global batch
    and the rank takes its rows' draws, so that every sample flips as it
    would in one process, as JAX draws over the global batch."""
    b = images.shape[0]
    draws = torch.rand(2, b if batch is None else batch, generator=generator,
                       device=generator.device)
    if rows is not None:
        draws = draws[:, rows.to(draws.device)]
    flip_h = (draws[0] < 0.5).view(b, 1, 1, 1)
    flip_v = (draws[1] < 0.5).view(b, 1, 1, 1)
    images = torch.where(flip_h, images.flip(-1), images)
    masks = torch.where(flip_h, masks.flip(-1), masks)
    images = torch.where(flip_v, images.flip(-2), images)
    masks = torch.where(flip_v, masks.flip(-2), masks)
    return images, masks
