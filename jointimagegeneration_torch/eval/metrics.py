"""Segmentation metrics for validation.

Counterparts of `jointimagegeneration_tpu/eval/metrics.py`'s `per_class_dice`
(the confusion-matrix Dice, in torch) and of its distribution metrics over
sets of sampled label volumes (numpy, host side): the pairwise 1 - IoU
distances, the generalized energy distance (GED) and the Hungarian-matched
IoU (HM-IoU).  FVD comes with the eval slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["confusion_matrix", "per_class_dice", "iou_distance_matrix", "generalized_energy_distance",
           "hungarian_matched_iou"]


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


def _iou_dist(a: np.ndarray, b: np.ndarray, num_classes: int, ignore: Sequence[int]) -> float:
    """1 - mean IoU over the classes not ignored that either volume holds (0
    when neither holds one)."""
    ious = []
    for c in range(num_classes):
        if c in ignore:
            continue
        pa, pb = a == c, b == c
        union = np.logical_or(pa, pb).sum()
        if union:
            ious.append(np.logical_and(pa, pb).sum() / union)
    return 1.0 - float(np.mean(ious)) if ious else 0.0


def iou_distance_matrix(samples: np.ndarray, references: np.ndarray, num_classes: int,
                        ignore: Sequence[int] = (0,)) -> np.ndarray:
    """(S, R) pairwise 1 - IoU distances between label volumes."""
    return np.array([[_iou_dist(s, r, num_classes, ignore) for r in references] for s in samples],
                    dtype=np.float64).reshape(len(samples), len(references))


def generalized_energy_distance(samples: np.ndarray, references: np.ndarray, num_classes: int,
                                ignore: Sequence[int] = (0,)) -> float:
    """GED^2 = 2 E[d(s, r)] - E[d(s, s')] - E[d(r, r')] with d = 1 - IoU."""
    d_sr = iou_distance_matrix(samples, references, num_classes, ignore).mean()
    d_ss = iou_distance_matrix(samples, samples, num_classes, ignore).mean()
    d_rr = iou_distance_matrix(references, references, num_classes, ignore).mean()
    return float(2 * d_sr - d_ss - d_rr)


def hungarian_matched_iou(samples: np.ndarray, references: np.ndarray, num_classes: int,
                          ignore: Sequence[int] = (0,)) -> float:
    """Mean IoU under the sample <-> reference assignment of least distance."""
    from scipy.optimize import linear_sum_assignment

    d = iou_distance_matrix(samples, references, num_classes, ignore)
    rows, cols = linear_sum_assignment(d)
    return float(1.0 - d[rows, cols].mean())
