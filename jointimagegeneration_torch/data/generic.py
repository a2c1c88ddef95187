"""Generic dataset wrappers: HDF5 cases, file lists, transformed pairs, image folders.

The port's copy of `jointimagegeneration_tpu/data/generic.py` (the
reference's `ccdm/ddpm/dataset_utils.py:26-206` and `ldm/data/base.py`):

  * `H5Dataset`: one group or dataset per case of an HDF5 file; one handle,
    opened lazily, with the open and every read under a lock, since the
    loader's worker threads share the object and HDF5 handles are not
    thread-safe;
  * `FileListDataset`: files from a list file or a glob, read by
    `_default_loader` (NIfTI through the datasets' native route, `.npy`, the
    first array of an `.npz`, else PIL);
  * `TransformedPairDataset`: a joint transform over (image, label) items and
    an optional one-hot of "label" into "mask" (the datasets' `one_hot_np`);
  * `ImageFolderDataset`: the images under a tree as [0, 1] float RGB,
    optionally centre-cropped and resized, and SR-degraded by
    `degradation_pipeline` into "lr".  The resize is the antialiased linear
    `jax.image.resize` the JAX class calls, computed without JAX by
    `data/transforms.resize_volume` (float32; within 1e-5 of it).

h5py and PIL are imported where they are used; a dataset whose items need one
checks at construction that it imports (`data/stock.require_packages`).
"""

from __future__ import annotations

import glob as _glob
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .datasets import EpochSeededRNG, one_hot_np, read_nifti
from .stock import require_packages

__all__ = ["H5Dataset", "FileListDataset", "TransformedPairDataset", "ImageFolderDataset"]


class H5Dataset:
    """Items from an HDF5 file (dataset_utils.py H5Dataset); the keys are
    read once at construction."""

    def __init__(self, path: str, keys: Optional[Sequence[str]] = None, transform: Optional[Callable] = None):
        require_packages("H5Dataset", "h5py")
        import h5py

        self.path = str(path)
        self._h5 = None
        self._h5_lock = threading.Lock()
        with h5py.File(self.path, "r") as f:
            self.keys = list(keys or f.keys())
        self.transform = transform

    def _file(self):
        import h5py

        if self._h5 is None:
            self._h5 = h5py.File(self.path, "r")
        return self._h5

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, i: int):
        with self._h5_lock:
            node = self._file()[self.keys[i]]
            if hasattr(node, "keys"):
                item = {k: np.asarray(node[k]) for k in node.keys()}
            else:
                item = {"data": np.asarray(node)}
        item["casename"] = self.keys[i]
        return self.transform(item) if self.transform else item


_ARRAY_SUFFIXES = (".nii", ".nii.gz", ".npy", ".npz")


class FileListDataset:
    """Images or arrays from a list file (`.txt` / `.lst`), a glob or a
    sequence of paths (dataset_utils.py FileListDataset)."""

    def __init__(self, files: Union[Sequence[str], str], loader: Optional[Callable] = None,
                 transform: Optional[Callable] = None):
        if isinstance(files, str):
            p = Path(files)
            if p.is_file() and p.suffix in (".txt", ".lst"):
                self.files = [line.strip() for line in p.read_text().splitlines() if line.strip()]
            else:
                self.files = sorted(_glob.glob(files))  # absolute or relative to the cwd
        else:
            self.files = list(files)
        if loader is None and not all(str(f).endswith(_ARRAY_SUFFIXES) for f in self.files):
            require_packages("FileListDataset (image files)", "PIL")
        self.loader = loader or _default_loader
        self.transform = transform

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int):
        item = {"image": self.loader(self.files[i]), "path": self.files[i]}
        return self.transform(item) if self.transform else item


def _default_loader(path: str) -> np.ndarray:
    p = str(path)
    if p.endswith((".nii", ".nii.gz")):
        return read_nifti(p)[0]
    if p.endswith(".npy"):
        return np.load(p)
    if p.endswith(".npz"):
        with np.load(p) as z:
            return z[list(z.files)[0]]
    from PIL import Image

    return np.asarray(Image.open(p))


class TransformedPairDataset:
    """(image, label) items with a joint transform and an optional one-hot
    (dataset_utils.py TransformedImgLblDataset)."""

    def __init__(self, base, transform: Optional[Callable] = None, num_classes: Optional[int] = None):
        self.base = base
        self.transform = transform
        self.num_classes = num_classes

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int):
        item = dict(self.base[i])
        if self.transform:
            item = self.transform(item)
        if self.num_classes and "label" in item:
            item["mask"] = one_hot_np(np.asarray(item.pop("label")), self.num_classes)
        return item


class ImageFolderDataset(EpochSeededRNG):
    """The images under a directory tree (ldm/data/lsun.py, imagenet.py) as
    {"image": (H, W, 3) float32 in [0, 1], "path"}, with `size` centre-
    cropped to a square and resized, and with `sr_factor` an "lr" image."""

    def __init__(self, root: str, size: Optional[int] = None, sr_factor: Optional[int] = None,
                 exts=(".png", ".jpg", ".jpeg", ".bmp"), seed: int = 0):
        require_packages("ImageFolderDataset", "PIL", *(("cv2",) if sr_factor else ()))
        self.files = sorted(str(p) for p in Path(root).rglob("*") if p.suffix.lower() in exts)
        self.size = size
        self.sr_factor = sr_factor
        self._rng_seed = seed

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        from PIL import Image

        from .transforms import resize_volume

        img = np.asarray(Image.open(self.files[i]).convert("RGB"), np.float32) / 255.0
        if self.size:
            h, w = img.shape[:2]
            s = min(h, w)
            img = img[(h - s) // 2:(h + s) // 2, (w - s) // 2:(w + s) // 2]
            img = resize_volume(img, (self.size, self.size, 3), "linear")
        item = {"image": img, "path": self.files[i]}
        if self.sr_factor:
            from .degradation import degradation_pipeline

            item["lr"], _ = degradation_pipeline(img, self._item_rng(i), sf=self.sr_factor)
        return item
