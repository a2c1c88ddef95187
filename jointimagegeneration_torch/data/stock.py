"""Stock image datasets: LSUN filelists, a local ImageNet tree, and SR pairs.

The port's copy of `jointimagegeneration_tpu/data/stock.py` (the reference's
`ldm/data/lsun.py` and `ldm/data/imagenet.py` semantics), item for item:

  * `LSUNBase` / `lsun_dataset`: a txt filelist under a data root ->
    {"relative_file_path_", "file_path_", "image" (size, size, 3) float32 in
    [-1, 1]}, centre-square crop, PIL resize, a p = flip_p horizontal flip;
  * `ImageNetLocal`: a LOCAL `<synset>/<file>` tree (nothing is downloaded),
    relpaths from a `filelist` or a directory scan, the reference's one
    ignored file, an optional synset filter, class ids from the sorted
    synsets, human labels from a `synset_human.txt` sidecar -> {"relpath",
    "file_path_", "synset", "class_label", "human_label", "image"};
    `process_images=False` leaves out "image" (the SR wrapper reads the file);
  * `SRDataset`: a square crop of side c min_side, c ~ U(min_crop_f,
    max_crop_f), the smallest side rescaled to `size` (cv2 INTER_AREA), and
    the LR image by a `cv_*` or `pil_*` interpolation or through
    `data/degradation.get_degradation` -> + {"image", "LR_image"} in [-1, 1];
  * `SRToLDMAdapter`: the stage-2 train contract {"image": HR, "cond": the LR
    image upsampled to HR with INTER_CUBIC}.

Every per-item draw comes from `EpochSeededRNG._item_rng(i)`.  PIL, cv2 and
scipy are imported inside the functions that use them; a dataset checks at
construction that the packages its items need import, and raises an
ImportError naming the missing one before the first step.
"""

from __future__ import annotations

import importlib
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .datasets import EpochSeededRNG

__all__ = ["LSUNBase", "lsun_dataset", "ImageNetLocal", "SRDataset", "SRToLDMAdapter", "require_packages"]

_PIL_INTERP = {"linear": "bilinear", "bilinear": "bilinear", "bicubic": "bicubic", "lanczos": "lanczos",
               "nearest": "nearest"}


def require_packages(what: str, *modules: str) -> None:
    """Raise an ImportError naming the first of `modules` that does not
    import (the distribution's name beside the module's)."""
    names = {"cv2": "opencv-python (cv2)", "PIL": "Pillow (PIL)"}
    for mod in modules:
        try:
            importlib.import_module(mod)
        except ImportError as e:
            raise ImportError(f"{what} needs the {names.get(mod, mod)} package, which does not import here "
                              f"({e})") from e


def _load_rgb(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def _center_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    crop = min(h, w)
    return img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]


def _pil_resize(img: np.ndarray, size: int, interpolation: str) -> np.ndarray:
    from PIL import Image

    resample = getattr(Image, _PIL_INTERP.get(interpolation, "bicubic").upper(), Image.BICUBIC)
    return np.asarray(Image.fromarray(img).resize((size, size), resample=resample), np.uint8)


class LSUNBase(EpochSeededRNG):
    """A txt filelist under `data_root` (lsun.py:9-59)."""

    def __init__(self, txt_file: str, data_root: str, size: Optional[int] = None, interpolation: str = "bicubic",
                 flip_p: float = 0.5, seed: int = 0):
        require_packages("LSUNBase", "PIL")
        self.image_paths = [line for line in Path(txt_file).read_text().splitlines() if line]
        self.data_root = str(data_root)
        self.size = size
        self.interpolation = interpolation
        self.flip_p = float(flip_p)
        self._rng_seed = seed

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, i: int) -> dict:
        rel = self.image_paths[i]
        path = os.path.join(self.data_root, rel)
        img = _center_square(_load_rgb(path))
        if self.size is not None:
            img = _pil_resize(img, self.size, self.interpolation)
        if self.flip_p > 0 and self._item_rng(i).random() < self.flip_p:
            img = img[:, ::-1]
        return {"relative_file_path_": rel, "file_path_": path, "image": img.astype(np.float32) / 127.5 - 1.0}


_LSUN_SPLITS = {  # (txt_file, data_root) of the reference's subclasses (lsun.py:62-92)
    ("churches", "train"): ("data/lsun/church_outdoor_train.txt", "data/lsun/churches"),
    ("churches", "val"): ("data/lsun/church_outdoor_val.txt", "data/lsun/churches"),
    ("bedrooms", "train"): ("data/lsun/bedrooms_train.txt", "data/lsun/bedrooms"),
    ("bedrooms", "val"): ("data/lsun/bedrooms_val.txt", "data/lsun/bedrooms"),
    ("cats", "train"): ("data/lsun/cat_train.txt", "data/lsun/cats"),
    ("cats", "val"): ("data/lsun/cat_val.txt", "data/lsun/cats"),
}


def lsun_dataset(category: str, split: str = "train", **kw) -> LSUNBase:
    """LSUNChurchesTrain / -Validation and the others; validation splits
    default to flip_p = 0, as the reference's subclasses."""
    try:
        txt, root = _LSUN_SPLITS[(category, split)]
    except KeyError:
        raise ValueError(f"unknown LSUN split {(category, split)!r}") from None
    kw.setdefault("txt_file", txt)
    kw.setdefault("data_root", root)
    if split == "val":
        kw.setdefault("flip_p", 0.0)
    return LSUNBase(**kw)


class ImageNetLocal(EpochSeededRNG):
    """An ImageNet-layout tree on disk (ImageNetBase._load, imagenet.py:
    93-133); see the module docstring for the items."""

    IGNORE = {"n06596364_9591.JPEG"}

    def __init__(self, data_root: str, filelist: Optional[str] = None, size: int = 256,
                 synsets: Optional[Sequence[str]] = None, process_images: bool = True, random_crop: bool = False,
                 flip_p: float = 0.0, seed: int = 0):
        if process_images:
            require_packages("ImageNetLocal", "PIL")
        root = Path(data_root)
        if filelist:
            relpaths = [line for line in Path(filelist).read_text().splitlines() if line]
        else:
            relpaths = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                              if p.suffix.lower() in (".jpeg", ".jpg", ".png") and p.parent != root)
        relpaths = [r for r in relpaths if r.split("/")[-1] not in self.IGNORE]
        if synsets is not None:
            keep = set(synsets)
            relpaths = [r for r in relpaths if r.split("/")[0] in keep]
        self.data_root = str(root)
        self.relpaths = relpaths
        self.synsets = [r.split("/")[0] for r in relpaths]
        class_dict = {s: i for i, s in enumerate(sorted(set(self.synsets)))}
        self.class_labels = [class_dict[s] for s in self.synsets]
        human = {}
        if (root / "synset_human.txt").exists():
            for line in (root / "synset_human.txt").read_text().splitlines():
                parts = line.split(maxsplit=1)
                if len(parts) == 2:
                    human[parts[0]] = parts[1]
        self.human_labels = [human.get(s, s) for s in self.synsets]
        self.size = size
        self.process_images = process_images
        self.random_crop = random_crop
        self.flip_p = float(flip_p)
        self._rng_seed = seed

    def __len__(self) -> int:
        return len(self.relpaths)

    def __getitem__(self, i: int) -> dict:
        rel = self.relpaths[i]
        path = os.path.join(self.data_root, rel)
        item = {"relpath": rel, "file_path_": path, "synset": self.synsets[i], "class_label": self.class_labels[i],
                "human_label": self.human_labels[i]}
        if not self.process_images:
            return item
        img = _load_rgb(path)
        rng = self._item_rng(i)
        if self.random_crop:
            crop = min(img.shape[:2])
            y = int(rng.integers(0, img.shape[0] - crop + 1))
            x = int(rng.integers(0, img.shape[1] - crop + 1))
            img = img[y:y + crop, x:x + crop]
        else:
            img = _center_square(img)
        img = _pil_resize(img, self.size, "bicubic")
        if self.flip_p > 0 and rng.random() < self.flip_p:
            img = img[:, ::-1]
        item["image"] = img.astype(np.float32) / 127.5 - 1.0
        return item


def _smallest_max_size(img: np.ndarray, size: int, interp: int) -> np.ndarray:
    """albumentations.SmallestMaxSize: the smallest side scaled to `size`,
    the aspect kept."""
    import cv2

    h, w = img.shape[:2]
    scale = size / min(h, w)
    return cv2.resize(img, (max(size, int(round(w * scale))), max(size, int(round(h * scale)))), interpolation=interp)


class SRDataset(EpochSeededRNG):
    """Super-resolution pairs over a base dataset of "file_path_" items
    (ImageNetSR, imagenet.py:272-374); see the module docstring."""

    _CV_INTERP = {"cv_nearest": 0, "cv_bilinear": 1, "cv_bicubic": 2, "cv_area": 3, "cv_lanczos": 4}

    def __init__(self, base, size: int, degradation: str = "bsrgan_light", downscale_f: int = 4,
                 min_crop_f: float = 0.5, max_crop_f: float = 1.0, random_crop: bool = True, seed: int = 0):
        assert size % downscale_f == 0, "size must divide by downscale_f"
        assert max_crop_f <= 1.0
        needs = ["PIL", "cv2"]
        if not degradation.startswith(("cv_", "pil_")):
            from .degradation import get_degradation

            get_degradation(degradation)  # an unknown name raises ValueError here
            needs.append("scipy")
        require_packages(f"SRDataset (degradation {degradation!r})", *needs)
        self.base = base
        self.size = size
        self.lr_size = size // downscale_f
        self.downscale_f = downscale_f
        self.min_crop_f, self.max_crop_f = float(min_crop_f), float(max_crop_f)
        self.center_crop = not random_crop
        self.degradation = degradation
        self._rng_seed = seed

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int) -> dict:
        import cv2

        example = dict(self.base[i])
        img = _load_rgb(example["file_path_"])
        rng = self._item_rng(i)
        crop = max(int(min(img.shape[:2]) * rng.uniform(self.min_crop_f, self.max_crop_f)), 1)
        if self.center_crop:
            y, x = (img.shape[0] - crop) // 2, (img.shape[1] - crop) // 2
        else:
            y = int(rng.integers(0, img.shape[0] - crop + 1))
            x = int(rng.integers(0, img.shape[1] - crop + 1))
        img = _smallest_max_size(img[y:y + crop, x:x + crop], self.size, cv2.INTER_AREA)
        if self.degradation.startswith("cv_"):
            lr_u8 = _smallest_max_size(img, self.lr_size, self._CV_INTERP[self.degradation])
        elif self.degradation.startswith("pil_"):
            lr_u8 = _pil_resize(img, self.lr_size, self.degradation[4:])
        else:
            from .degradation import get_degradation

            lr, _ = get_degradation(self.degradation)(img.astype(np.float32) / 255.0, rng, sf=self.downscale_f)
            lr_u8 = (np.clip(lr, 0, 1) * 255.0).round().astype(np.uint8)
        example["image"] = img.astype(np.float32) / 127.5 - 1.0
        example["LR_image"] = lr_u8.astype(np.float32) / 127.5 - 1.0
        return example


class SRToLDMAdapter:
    """SRDataset items as the stage-2 train contract: {"image": HR, "cond":
    the LR image upsampled bicubic (cv2.INTER_CUBIC) to the HR size}, the
    reference SR configs' concat conditioning."""

    def __init__(self, sr: SRDataset):
        require_packages("SRToLDMAdapter", "cv2")
        self.sr = sr

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sr, "set_epoch"):
            self.sr.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sr)

    def __getitem__(self, i: int) -> dict:
        import cv2

        it = self.sr[i]
        h, w = it["image"].shape[:2]
        cond = cv2.resize(it["LR_image"], (w, h), interpolation=cv2.INTER_CUBIC)
        return {"image": it["image"], "cond": cond.reshape(it["image"].shape)}
