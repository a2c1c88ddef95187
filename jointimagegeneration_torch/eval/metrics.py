"""Segmentation and distribution metrics.

Counterparts of `jointimagegeneration_tpu/eval/metrics.py`: the
confusion-matrix Dice, precision and recall (in torch), the distribution
metrics over sets of sampled label volumes (numpy, host side: the pairwise
1 - IoU distances, the generalized energy distance (GED) and the
Hungarian-matched IoU (HM-IoU)), and the Frechet distance between two sets of
feature vectors, the core of FVD (numpy and scipy).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["confusion_matrix", "dice_from_confusion", "per_class_dice", "per_class_precision_recall",
           "iou_distance_matrix", "generalized_energy_distance", "hungarian_matched_iou", "frechet_distance"]


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) counts[i, j] = #{target == i and pred == j} over all voxels."""
    idx = target.reshape(-1).long() * num_classes + pred.reshape(-1).long()
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def dice_from_confusion(cm: torch.Tensor, ignore_index: Optional[int] = None) -> torch.Tensor:
    """Per-class Dice 2 tp / (2 tp + fp + fn) (0 for a class absent from both),
    fp32; `ignore_index` dropped."""
    cm = cm.float()
    tp = torch.diagonal(cm)
    dice = 2 * tp / (2 * tp + (cm.sum(0) - tp) + (cm.sum(1) - tp)).clamp_min(1)
    if ignore_index is not None:
        dice = dice[torch.arange(cm.shape[0], device=dice.device) != ignore_index]
    return dice


def per_class_dice(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                   ignore_index: Optional[int] = None) -> torch.Tensor:
    return dice_from_confusion(confusion_matrix(pred, target, num_classes), ignore_index)


def per_class_precision_recall(pred: torch.Tensor, target: torch.Tensor, num_classes: int):
    """(precision, recall) per class, fp32: tp over the predicted and over the
    target count (0 for a class absent from either)."""
    cm = confusion_matrix(pred, target, num_classes).float()
    tp = torch.diagonal(cm)
    return tp / cm.sum(0).clamp_min(1), tp / cm.sum(1).clamp_min(1)


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


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """||mu_a - mu_b||^2 + tr(Sa + Sb - 2 (Sa Sb)^(1/2)) of two (N, D) feature sets."""
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    sa = np.cov(feats_a, rowvar=False)
    sb = np.cov(feats_b, rowvar=False)
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(sa) + np.trace(sb) - 2 * _trace_sqrt_product(sa, sb, eps))


def _trace_sqrt_product(sa: np.ndarray, sb: np.ndarray, eps: float) -> float:
    """tr((Sa Sb)^(1/2)): scipy's sqrtm first; where it raises or gives
    non-finite values (the rank-deficient covariances of a few samples, two
    of them for instance), the PSD-safe tr((Sa^(1/2) Sb Sa^(1/2))^(1/2)) by
    eigh, eigenvalues clipped at 0."""
    from scipy import linalg

    try:
        covmean = linalg.sqrtm(sa @ sb)
        if isinstance(covmean, tuple):  # older scipy returns (sqrtm, errest)
            covmean = covmean[0]
        if np.isfinite(covmean).all():
            return float(np.trace(covmean.real if np.iscomplexobj(covmean) else covmean))
    except Exception:
        pass
    n = sa.shape[0]
    wa, va = np.linalg.eigh((sa + sa.T) / 2 + eps * np.eye(n))
    root_a = (va * np.sqrt(np.clip(wa, 0, None))) @ va.T
    m = root_a @ ((sb + sb.T) / 2 + eps * np.eye(n)) @ root_a
    w = np.linalg.eigvalsh((m + m.T) / 2)
    return float(np.sum(np.sqrt(np.clip(w, 0, None))))
