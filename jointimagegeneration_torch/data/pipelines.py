"""Composable 2D image + label transforms, built by name.

The port's copy of `jointimagegeneration_tpu/data/pipelines.py` (the
`dataset_pipeline_train: ["flip", "resize", "colorjitter",
"torchvision_normalise"]` pipeline of the reference's params.yml): each
transform takes and returns an item dict and draws from the Generator it is
given.  "image" is (H, W, ...) float, "label" (H, W, ...) integer; labels are
always resampled nearest, and the photometric transforms touch the image only.
`_resize2d` resamples through `transforms.resize_volume`, as the JAX one
through `jax.image.resize`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .transforms import resize_volume

__all__ = ["Compose", "flip", "make_resize", "make_random_scale", "make_random_crop", "make_pad",
           "make_colorjitter", "make_normalise", "build_transforms"]


class Compose:
    def __init__(self, fns: Sequence[Callable]):
        self.fns = list(fns)

    def __call__(self, item: dict, rng: np.random.Generator) -> dict:
        for f in self.fns:
            item = f(item, rng)
        return item


def _resize2d(arr: np.ndarray, hw: Tuple[int, int], nearest: bool) -> np.ndarray:
    """Resize the two leading axes of `arr` (any trailing axes kept)."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return resize_volume(arr[..., None], (hw[0], hw[1], 1), "nearest" if nearest else "linear")[..., 0]
    lead = arr.reshape(arr.shape[:2] + (-1,))  # (H, W, rest) as a 3-axis volume
    out = resize_volume(lead, (hw[0], hw[1], lead.shape[2]), "nearest" if nearest else "linear")
    return out.reshape(tuple(hw) + arr.shape[2:])


def flip(item: dict, rng: np.random.Generator, p: float = 0.5) -> dict:
    """Horizontal flip of the image and the label together, with probability p."""
    if rng.random() < p:
        for k in ("image", "label"):
            if k in item:
                item[k] = np.flip(item[k], axis=1).copy()
    return item


def make_resize(target_size: Tuple[int, int]):
    def resize(item: dict, rng) -> dict:
        if "image" in item:
            item["image"] = _resize2d(np.asarray(item["image"], np.float32), target_size, nearest=False)
        if "label" in item:
            item["label"] = _resize2d(item["label"], target_size, nearest=True)
        return item

    return resize


def make_random_scale(scale_range: Tuple[float, float] = (0.75, 1.25)):
    """One uniform scale draw a call, applied to the image and the label."""

    def random_scale(item: dict, rng: np.random.Generator) -> dict:
        s = rng.uniform(*scale_range)
        for k, nearest in (("image", False), ("label", True)):
            if k in item:
                h, w = item[k].shape[:2]
                item[k] = _resize2d(item[k], (int(h * s), int(w * s)), nearest=nearest)
        return item

    return random_scale


def make_random_crop(crop_hw: Tuple[int, int], cat_max_ratio: float = 0.75, num_attempts: int = 10):
    """Random crop that re-draws its window (up to `num_attempts` times) while
    one class covers more than `cat_max_ratio` of the label in it."""

    def random_crop(item: dict, rng: np.random.Generator) -> dict:
        img, lbl = item.get("image"), item.get("label")
        h, w = (img if img is not None else lbl).shape[:2]
        ch, cw = min(crop_hw[0], h), min(crop_hw[1], w)

        def window():
            return int(rng.integers(0, h - ch + 1)), int(rng.integers(0, w - cw + 1))

        y, x = window()
        if lbl is not None and cat_max_ratio < 1.0:
            for _ in range(num_attempts):
                _, counts = np.unique(lbl[y:y + ch, x:x + cw], return_counts=True)
                if counts.size > 1 and counts.max() / counts.sum() <= cat_max_ratio:
                    break
                y, x = window()
        if img is not None:
            item["image"] = img[y:y + ch, x:x + cw]
        if lbl is not None:
            item["label"] = lbl[y:y + ch, x:x + cw]
        return item

    return random_crop


def make_pad(size_hw: Tuple[int, int], pad_value: float = 0.0, label_pad: int = 0):
    """Pad the image and the label at the bottom and right up to `size_hw`."""

    def pad(item: dict, rng) -> dict:
        for k, v in (("image", pad_value), ("label", label_pad)):
            if k in item:
                a = item[k]
                ph, pw = max(0, size_hw[0] - a.shape[0]), max(0, size_hw[1] - a.shape[1])
                if ph or pw:
                    item[k] = np.pad(a, [(0, ph), (0, pw)] + [(0, 0)] * (a.ndim - 2), constant_values=v)
        return item

    return pad


def make_colorjitter(brightness: float = 0.2, contrast: float = 0.2):
    """image * U(1 - contrast, 1 + contrast) + U(-brightness, brightness),
    clipped into [0, 1] (the contrast drawn first)."""

    def colorjitter(item: dict, rng: np.random.Generator) -> dict:
        img = item.get("image")
        if img is None:
            return item
        img = np.asarray(img, np.float32)
        img = img * rng.uniform(1 - contrast, 1 + contrast) + rng.uniform(-brightness, brightness)
        item["image"] = np.clip(img, 0.0, 1.0)
        return item

    return colorjitter


def make_normalise(mean: float = 0.5, std: float = 0.5):
    """torchvision's Normalize: [0, 1] -> about [-1, 1] at the defaults."""

    def normalise(item: dict, rng) -> dict:
        if "image" in item:
            item["image"] = (np.asarray(item["image"], np.float32) - mean) / std
        return item

    return normalise


def build_transforms(names: Sequence[str], settings: Optional[dict] = None) -> Compose:
    """The pipeline of `names` (params.yml's `dataset_pipeline_*` keys);
    `settings` holds target_size (512, 512), scale_range and cat_max_ratio."""
    settings = settings or {}
    target = tuple(settings.get("target_size", (512, 512)))
    table: Dict[str, Callable] = {
        "flip": flip,
        "resize": make_resize(target),
        "randomscale": make_random_scale(tuple(settings.get("scale_range", (0.75, 1.25)))),
        "randomcrop": make_random_crop(target, settings.get("cat_max_ratio", 0.75)),
        "pad": make_pad(target),
        "colorjitter": make_colorjitter(),
        "torchvision_normalise": make_normalise(),
    }
    return Compose([table[n] for n in names])
