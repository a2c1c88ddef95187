"""Datasets for both stages: the Ruijin and nnUNet layouts, and synthetic cases.

The port's copies of `jointimagegeneration_tpu/data/datasets.py`, on its numpy
route only (the JAX package takes `native/libjig_native.so` for the NIfTI
decode, the label remap, `window_norm` and the one-hot when it is built; the
port has no native library):

  * `RuijinMaskDataset` (stage 1): a JSON index of {totalseg, crcseg, text,
    text_features} per case -> a 12-class one-hot (D, H, W, C) volume resized
    (nearest) to `volume_shape`, flipped along W at random in training, a
    zeros image, the first array of the `text_features` `.npz` as "context";
  * `RuijinSlicePairDataset` (stage 2): windowed CT and remapped labels,
    cropped or padded to the slice shape, one random slice z per item:
    image = slice z, cond = [slice z - 1 (zeros at z = 0) | labels of z /
    (C - 1)], the whole volumes outside training; an optional HDF5 cache of
    the decoded volumes (`cache_h5`, `h5py` imported only then);
  * `RuijinVolumeDataset` (3D): windowed CT resized linearly, labels
    nearest, at `volume_shape`;
  * `NNUNetLayoutDataset` (stage 2): `imagesTr/<case>_0000.nii.gz` +
    `labelsTr/<case>.nii.gz` slice pairs, as `RuijinSlicePairDataset`;
  * `SyntheticMaskDataset` / `SyntheticSliceDataset`: ellipsoid 'organs' in
    a random abdomen, so every path runs without patient data.

Every random draw of an item comes from `default_rng((seed, epoch, index))`
(`EpochSeededRNG`), so items are reproducible and the loader's worker threads
share no generator.  Index paths are relative to the index file's directory
unless absolute.  Items are numpy dicts; batching is in `data/loader.py`.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .classes import NUM_CLASSES, remap_totalseg_labels
from .nifti import read_nifti
from .transforms import crop_or_pad, one_hot_np, random_flip, resize_volume, window_norm

__all__ = ["NUM_CLASSES", "one_hot_np", "synthesize_case", "EpochSeededRNG", "train_val_split", "RuijinMaskDataset",
           "RuijinSlicePairDataset", "RuijinVolumeDataset", "NNUNetLayoutDataset", "SyntheticMaskDataset",
           "SyntheticSliceDataset"]


class EpochSeededRNG:
    """Per-item augmentation draws from a Generator seeded by (seed, epoch,
    index): thread-safe under the loader's worker pool and reproducible;
    the loader calls `set_epoch` each pass so the draws vary by epoch."""

    _rng_seed: int = 0
    _epoch: int = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _item_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self._rng_seed, self._epoch, index))


def train_val_split(keys: Sequence[str], val_fraction: float = 0.05, seed: int = 0):
    """(train keys, val keys), both sorted: max(1, int(n * val_fraction)) of
    the sorted keys go to val by `default_rng(seed).permutation`."""
    keys = sorted(keys)
    perm = np.random.default_rng(seed).permutation(len(keys))
    val = {keys[i] for i in perm[:max(1, int(len(keys) * val_fraction))]}
    return [k for k in keys if k not in val], [k for k in keys if k in val]


class _IndexedCases:
    """The JSON index, the split's keys and path resolution shared by the
    Ruijin datasets."""

    def _load_index(self, index_path: str, split: str, val_fraction: float, seed: int) -> None:
        with open(index_path) as f:
            self.index: Dict[str, dict] = json.load(f)
        train_keys, val_keys = train_val_split(list(self.index), val_fraction, seed)
        self.keys = train_keys if split == "train" else val_keys
        self.base = Path(index_path).parent

    def __len__(self) -> int:
        return len(self.keys)

    def _resolve(self, p: str) -> str:
        return p if os.path.isabs(p) else str(self.base / p)

    def _labels(self, case: dict) -> np.ndarray:
        """The case's TotalSegmentator volume remapped to class ids, its
        crcseg tumour (when the index names one) as the last class."""
        seg, _ = read_nifti(self._resolve(case["totalseg"]))
        tumor = read_nifti(self._resolve(case["crcseg"]))[0] if case.get("crcseg") else None
        return remap_totalseg_labels(seg, tumor)


def _slice_item(img: np.ndarray, labels: np.ndarray, z: int, name: str, num_classes: int,
                include_volumes: bool) -> dict:
    """Slice z of a windowed (D, H, W) CT volume and its labels as a stage-2
    item: "image" (H, W, 1), "cond" (H, W, 2) = [slice z - 1 (zeros at z = 0)
    | labels / (C - 1)]; with `include_volumes` "wholeimage" and "wholemask"
    (D, H, W, 1)."""
    prev = img[z - 1] if z > 0 else np.zeros_like(img[0])
    scale = max(num_classes - 1, 1)
    item = {"image": img[z][..., None].astype(np.float32),
            "cond": np.stack([prev, labels[z].astype(np.float32) / scale], axis=-1).astype(np.float32),
            "casename": name}
    if include_volumes:
        item["wholeimage"] = img[..., None].astype(np.float32)
        item["wholemask"] = (labels.astype(np.float32) / scale)[..., None]
    return item


class RuijinMaskDataset(_IndexedCases, EpochSeededRNG):
    """Stage-1 mask volumes from a JSON index ({case: {"totalseg", "crcseg",
    "text", "text_features"}}; `max_size` keeps the split's first cases)."""

    def __init__(self, index_path: str, split: str = "train", volume_shape: Tuple[int, int, int] = (64, 128, 128),
                 num_classes: int = NUM_CLASSES, val_fraction: float = 0.05, augment: bool = True,
                 max_size: Optional[int] = None, seed: int = 0):
        self._load_index(index_path, split, val_fraction, seed)
        if max_size:
            self.keys = self.keys[:max_size]
        self.volume_shape = tuple(volume_shape)
        self.num_classes = num_classes
        self.augment = augment and split == "train"
        self._rng_seed = seed + (0 if split == "train" else 1)

    def __getitem__(self, i: int) -> dict:
        case = self.index[self.keys[i]]
        labels = resize_volume(self._labels(case), self.volume_shape, "nearest").astype(np.int32)
        if self.augment:
            (labels,) = random_flip(self._item_rng(i), labels, axis=-1)
        # the image is a zeros placeholder: the stage-1 config conditions on a zero channel
        item = {"mask": one_hot_np(labels, self.num_classes),
                "image": np.zeros(self.volume_shape + (1,), np.float32), "casename": self.keys[i]}
        if case.get("text_features"):
            with np.load(self._resolve(case["text_features"])) as z:
                item["context"] = z[z.files[0]].astype(np.float32)
        if case.get("text"):
            item["text"] = case["text"]
        return item


class RuijinSlicePairDataset(_IndexedCases, EpochSeededRNG):
    """Stage-2 (image, [prev, mask]) slice pairs from the index's CT
    ("image"), "totalseg" and "crcseg" volumes; splits other than 'train'
    carry the whole volumes.  `cache_h5` names an HDF5 file that keeps each
    case's decoded volumes (`h5py` is imported only then); the loader's
    threads share it under a lock and decode misses outside it."""

    def __init__(self, index_path: str, split: str = "train", slice_shape: Tuple[int, int] = (512, 512),
                 num_classes: int = NUM_CLASSES, val_fraction: float = 0.05, include_volumes: bool = False,
                 cache_h5: Optional[str] = None, seed: int = 0):
        self._load_index(index_path, split, val_fraction, seed)
        self.slice_shape = tuple(slice_shape)
        self.num_classes = num_classes
        self.include_volumes = include_volumes or split != "train"
        self._rng_seed = seed + 17
        self.cache_h5 = cache_h5
        self._h5 = None
        self._h5_lock = threading.Lock()

    def _load_case_uncached(self, case: dict):
        img, _ = read_nifti(self._resolve(case["image"]))
        labels = self._labels(case)
        img = window_norm(img)
        return (crop_or_pad(img, (img.shape[0],) + self.slice_shape),
                crop_or_pad(labels, (labels.shape[0],) + self.slice_shape))

    def _load_case(self, case: dict, key: str):
        if not self.cache_h5:
            return self._load_case_uncached(case)
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"cache_h5 needs the h5py package ({e}); leave cache_h5 unset to decode "
                              "every item") from e
        with self._h5_lock:
            if self._h5 is None:
                self._h5 = h5py.File(self.cache_h5, "a")
            if key in self._h5:
                g = self._h5[key]
                return np.asarray(g["image"]), np.asarray(g["labels"])
        img, labels = self._load_case_uncached(case)
        with self._h5_lock:
            if key not in self._h5:  # another thread may have filled the same miss
                g = self._h5.create_group(key)
                g.create_dataset("image", data=img, compression="lzf")
                g.create_dataset("labels", data=labels.astype(np.int16), compression="lzf")
                self._h5.flush()
        return img, labels

    def __getitem__(self, i: int) -> dict:
        img, labels = self._load_case(self.index[self.keys[i]], self.keys[i])
        z = int(self._item_rng(i).integers(0, img.shape[0]))
        return _slice_item(img, labels, z, self.keys[i], self.num_classes, self.include_volumes)


class RuijinVolumeDataset(_IndexedCases):
    """Windowed CT volume (linear resize) + one-hot mask volume (nearest) +
    text, at `volume_shape`."""

    def __init__(self, index_path: str, split: str = "train", volume_shape: Tuple[int, int, int] = (64, 128, 128),
                 num_classes: int = NUM_CLASSES, val_fraction: float = 0.05, seed: int = 0):
        self._load_index(index_path, split, val_fraction, seed)
        self.volume_shape = tuple(volume_shape)
        self.num_classes = num_classes

    def __getitem__(self, i: int) -> dict:
        case = self.index[self.keys[i]]
        img, _ = read_nifti(self._resolve(case["image"]))
        labels = self._labels(case)
        img = resize_volume(window_norm(img), self.volume_shape, "linear")
        labels = resize_volume(labels, self.volume_shape, "nearest").astype(np.int32)
        item = {"image": img[..., None].astype(np.float32), "mask": one_hot_np(labels, self.num_classes),
                "casename": self.keys[i]}
        if case.get("text"):
            item["text"] = case["text"]
        return item


class NNUNetLayoutDataset(EpochSeededRNG):
    """Stage-2 slice pairs from an nnUNet tree: `imagesTr/<case>_0000.nii.gz`
    (CT) and `labelsTr/<case>.nii.gz` (class ids as they are)."""

    def __init__(self, root: str, split: str = "train", slice_shape: Tuple[int, int] = (512, 512),
                 num_classes: int = NUM_CLASSES, val_fraction: float = 0.05, include_volumes: bool = False,
                 seed: int = 0):
        self.root = Path(root)
        cases = sorted(p.name.replace("_0000.nii.gz", "") for p in (self.root / "imagesTr").glob("*_0000.nii.gz"))
        train_keys, val_keys = train_val_split(cases, val_fraction, seed)
        self.keys = train_keys if split == "train" else val_keys
        self.slice_shape = tuple(slice_shape)
        self.num_classes = num_classes
        self.include_volumes = include_volumes or split != "train"
        self._rng_seed = seed + 31

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int) -> dict:
        name = self.keys[i]
        img, _ = read_nifti(self.root / "imagesTr" / f"{name}_0000.nii.gz")
        labels, _ = read_nifti(self.root / "labelsTr" / f"{name}.nii.gz")
        img = window_norm(img)
        img = crop_or_pad(img, (img.shape[0],) + self.slice_shape)
        labels = crop_or_pad(labels.astype(np.int32), (labels.shape[0],) + self.slice_shape)
        z = int(self._item_rng(i).integers(0, img.shape[0]))
        return _slice_item(img, labels, z, name, self.num_classes, self.include_volumes)


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
        return _slice_item(img, labels, z, f"synth_{i:04d}", self.num_classes, self.include_volumes)
