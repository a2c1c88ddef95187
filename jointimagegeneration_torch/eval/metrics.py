"""Segmentation metrics for validation.

Counterpart of `per_class_dice` in `jointimagegeneration_tpu/eval/metrics.py`
(the confusion-matrix Dice); the distribution metrics come with the eval
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["confusion_matrix", "per_class_dice"]


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) counts[i, j] = #{target == i and pred == j} over all voxels."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def per_class_dice(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                   ignore_index: Optional[int] = None) -> torch.Tensor:
    """Per-class Dice 2 tp / (2 tp + fp + fn) (0 for a class absent from both),
    fp32; `ignore_index` dropped."""
    cm = confusion_matrix(pred, target, num_classes).float()
    tp = torch.diagonal(cm)
    dice = 2 * tp / (2 * tp + (cm.sum(0) - tp) + (cm.sum(1) - tp)).clamp_min(1)
    if ignore_index is not None:
        dice = dice[torch.arange(num_classes, device=dice.device) != ignore_index]
    return dice
