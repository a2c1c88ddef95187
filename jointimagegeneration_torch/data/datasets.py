"""Synthetic datasets: ellipsoid 'organs' in a random abdomen.

Copies of `SyntheticMaskDataset` (stage 1), `SyntheticSliceDataset` (stage 2)
and the helpers they call from `jointimagegeneration_tpu/data/datasets.py`
and `data/transforms.py`, with the same seeds, so the port and the JAX package
see the same cases.  Items are numpy dicts; batching is in `data/loader.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .transforms import window_norm

__all__ = ["NUM_CLASSES", "one_hot_np", "synthesize_case", "SyntheticMaskDataset", "SyntheticSliceDataset"]

NUM_CLASSES = 12  # background + 11 abdominal structures (data/classes.py)


def one_hot_np(labels: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    """(...,) int -> (..., C) one-hot, trailing class axis."""
    return np.eye(num_classes, dtype=dtype)[np.clip(labels, 0, num_classes - 1)]


def _ellipsoid(shape, center, radii) -> np.ndarray:
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    acc = np.zeros(shape, np.float32)
    for g, c, r in zip(grids, center, radii):
        acc = acc + ((g - c) / max(r, 1e-3)) ** 2
    return acc <= 1.0


def synthesize_case(rng: np.random.Generator, shape: Tuple[int, int, int], num_classes: int) -> np.ndarray:
    """Random 'abdomen': background 0, one ellipsoid per further class."""
    labels = np.zeros(shape, np.int32)
    for cls in range(1, num_classes):
        center = [rng.uniform(0.2, 0.8) * s for s in shape]
        radii = [rng.uniform(0.05, 0.22) * s for s in shape]
        labels[_ellipsoid(shape, center, radii)] = cls
    return labels


class SyntheticMaskDataset:
    """Case i: {"mask": one-hot (D, H, W, C) float32, "image": zeros (D, H, W,
    1), "casename"} (+ "context" N(0, 1) of `context_shape`)."""

    def __init__(self, num_cases: int = 16, volume_shape=(64, 128, 128), num_classes: int = NUM_CLASSES,
                 context_shape: Optional[Tuple[int, int]] = None, seed: int = 0):
        self.num_cases = num_cases
        self.volume_shape = tuple(volume_shape)
        self.num_classes = num_classes
        self.context_shape = context_shape
        self.seed = seed

    def __len__(self) -> int:
        return self.num_cases

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + i)
        labels = synthesize_case(rng, self.volume_shape, self.num_classes)
        item = {
            "mask": one_hot_np(labels, self.num_classes),
            "image": np.zeros(self.volume_shape + (1,), np.float32),
            "casename": f"synth_{i:04d}",
        }
        if self.context_shape is not None:
            item["context"] = rng.standard_normal(self.context_shape).astype(np.float32)
        return item


class SyntheticSliceDataset:
    """Case i: a synthetic (depth, *slice_shape) volume windowed into [0, 1]
    and one random slice z of it: {"image": (H, W, 1) float32, "cond": (H, W,
    2) [slice z - 1 (zeros at z = 0) | labels of slice z / (C - 1)],
    "casename"}; with `include_volumes` also "wholeimage" (D, H, W, 1) and
    "wholemask" (D, H, W, 1), the labels / (C - 1)."""

    def __init__(self, num_cases: int = 16, slice_shape=(512, 512), depth: int = 8,
                 num_classes: int = NUM_CLASSES, include_volumes: bool = False, seed: int = 0):
        self.num_cases = num_cases
        self.slice_shape = tuple(slice_shape)
        self.depth = depth
        self.num_classes = num_classes
        self.include_volumes = include_volumes
        self.seed = seed

    def __len__(self) -> int:
        return self.num_cases

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng(self.seed * 65537 + i)
        shape = (self.depth,) + self.slice_shape
        labels = synthesize_case(rng, shape, self.num_classes)
        img = window_norm(labels * 30.0 + rng.standard_normal(shape) * 20.0, 60, 360)
        z = int(rng.integers(0, self.depth))
        prev = img[z - 1] if z > 0 else np.zeros_like(img[0])
        mask_slice = labels[z].astype(np.float32) / max(self.num_classes - 1, 1)
        item = {
            "image": img[z][..., None].astype(np.float32),
            "cond": np.stack([prev, mask_slice], axis=-1).astype(np.float32),
            "casename": f"synth_{i:04d}",
        }
        if self.include_volumes:
            item["wholeimage"] = img[..., None].astype(np.float32)
            item["wholemask"] = (labels.astype(np.float32) / max(self.num_classes - 1, 1))[..., None]
        return item
