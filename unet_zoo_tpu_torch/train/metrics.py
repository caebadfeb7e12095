"""Segmentation metrics. Counterpart of ``unet_zoo_tpu/train/metrics.py:14-116``.

``dice_coefficient`` and ``iou_score`` stay on the device (no ``.item()``);
``boundary_f1`` is a host metric over numpy masks; ``check_dataset_integrity``
logs a few masks' values before a run.
"""

from __future__ import annotations

import torch


def _binary(prediction_logits: torch.Tensor, threshold: float) -> torch.Tensor:
    return (torch.sigmoid(prediction_logits.float()) > threshold).float()


def dice_parts(prediction_logits: torch.Tensor, target: torch.Tensor,
               threshold: float = 0.5) -> torch.Tensor:
    """[intersection, union] of the thresholded prediction and the target,
    summed over the batch: the sums a data-parallel step adds over the ranks
    before it forms one Dice ratio of the global batch."""
    pred, tgt = _binary(prediction_logits, threshold), target.float()
    return torch.stack([(pred * tgt).sum(), pred.sum() + tgt.sum()])


def dice_from_parts(parts: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """Dice from :func:`dice_parts` (``[..., 2]``); 1.0 where the union is 0."""
    inter, union = parts[..., 0], parts[..., 1]
    dice = (2.0 * inter + epsilon) / (union + epsilon)
    return torch.where(union == 0, torch.ones_like(dice), dice)


def dice_coefficient(prediction_logits: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-7, threshold: float = 0.5) -> torch.Tensor:
    """Thresholded binary Dice over the whole batch; 1.0 where both the
    prediction and the target are empty (``union == 0``)."""
    return dice_from_parts(dice_parts(prediction_logits, target, threshold), epsilon)


def iou_score(prediction_logits: torch.Tensor, target: torch.Tensor,
              epsilon: float = 1e-7, threshold: float = 0.5) -> torch.Tensor:
    """Thresholded binary IoU over the whole batch; 1.0 where ``union == 0``."""
    pred, tgt = _binary(prediction_logits, threshold), target.float()
    inter = (pred * tgt).sum()
    union = pred.sum() + tgt.sum() - inter
    iou = (inter + epsilon) / (union + epsilon)
    return torch.where(union == 0, torch.ones_like(iou), iou)


def check_dataset_integrity(dataset_path: str, logger) -> None:
    """Log the unique values and shape of the first three masks of each
    split (``{split}/masks``); PIL is imported only where such a directory
    exists."""
    import os

    import numpy as np

    logger.log_both("Checking dataset integrity...")
    for split in ["train", "test", "valid"]:
        masks_path = os.path.join(dataset_path, split, "masks")
        if os.path.exists(masks_path):
            from PIL import Image

            mask_files = [
                f for f in os.listdir(masks_path)
                if f.endswith((".png", ".jpg", ".jpeg"))
            ][:3]
            for mask_file in mask_files:
                mask = Image.open(os.path.join(masks_path, mask_file)).convert("L")
                arr = np.array(mask)
                logger.log_both(
                    f"{split}/{mask_file}: unique values = {np.unique(arr)}, "
                    f"shape = {arr.shape}")


def boundary_f1(pred_mask, target_mask, tolerance: int = 2) -> float:
    """Boundary F1 between binary [H, W] masks (anything squeezable to it):
    precision is the share of predicted boundary pixels within
    ``tolerance`` (Euclidean) of a target boundary pixel, recall the
    converse. Boundaries are 4-connected inner contours (mask minus its
    erosion). Both boundary-free: 1.0; exactly one: 0.0."""
    import numpy as np
    from scipy import ndimage

    def contour(m):
        m = np.squeeze(np.asarray(m).astype(bool))
        er = ndimage.binary_erosion(m, structure=ndimage.generate_binary_structure(2, 1),
                                    border_value=0)
        return m & ~er

    bp, bt = contour(pred_mask), contour(target_mask)
    n_p, n_t = int(bp.sum()), int(bt.sum())
    if n_p == 0 and n_t == 0:
        return 1.0
    if n_p == 0 or n_t == 0:
        return 0.0
    precision = float((ndimage.distance_transform_edt(~bt)[bp] <= tolerance).mean())
    recall = float((ndimage.distance_transform_edt(~bp)[bt] <= tolerance).mean())
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)
