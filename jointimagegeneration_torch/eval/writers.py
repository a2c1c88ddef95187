"""Image grids and PNG files for the qualitative panels.

The port's own copy of the grid functions of `jointimagegeneration_tpu/eval/
writers.py` (`make_grid`, `image_volume_to_grid`, `labels_to_grid`,
`overlay_mask_on_image`), all numpy, and `save_grid_png`, which encodes the
PNG with the standard library's zlib and struct (8-bit grey or RGB, no
filter), so it needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Sequence

import numpy as np

from ..data.classes import NUM_CLASSES, class_color_map, labels_to_colors

__all__ = ["make_grid", "image_volume_to_grid", "labels_to_grid", "overlay_mask_on_image", "encode_png",
           "save_grid_png"]


def make_grid(images: Sequence[np.ndarray], ncols: int = 8, pad: int = 2) -> np.ndarray:
    """(N, H, W, 3) uint8 -> one grid image, `ncols` wide, `pad` black pixels
    between the panels."""
    images = [np.asarray(im) for im in images]
    n = len(images)
    h, w = images[0].shape[:2]
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    grid = np.zeros((nrows * (h + pad) - pad, ncols * (w + pad) - pad, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, ncols)
        grid[r * (h + pad): r * (h + pad) + h, c * (w + pad): c * (w + pad) + w] = im
    return grid


def image_volume_to_grid(vol: np.ndarray, every: int = 4) -> np.ndarray:
    """(D, H, W) float volume in [0, 1] -> a grey RGB grid of every `every`-th
    slice; (H, W) renders as one panel."""
    vol = np.clip(np.asarray(vol), 0, 1)
    if vol.ndim == 2:
        vol = vol[None]
    return make_grid([(np.stack([vol[z]] * 3, -1) * 255).astype(np.uint8) for z in range(0, vol.shape[0], every)])


def labels_to_grid(labels: np.ndarray, every: int = 4) -> np.ndarray:
    """(D, H, W) label volume -> a colour grid of every `every`-th slice;
    (H, W) renders as one panel."""
    labels = np.asarray(labels)
    if labels.ndim == 2:
        labels = labels[None]
    return make_grid([labels_to_colors(labels[z]) for z in range(0, labels.shape[0], every)])


def overlay_mask_on_image(image: np.ndarray, labels: np.ndarray, overlay_coef: float = 0.2,
                          boundaries: bool = True) -> np.ndarray:
    """Class colours blended over a CT image in [0, 1]: background (class 0)
    shows the image, labelled voxels `colour * coef + image * (1 - coef)`,
    and each class's boundary (Sobel magnitude over every axis, the lowest
    class id winning where boundaries touch) in its solid colour.  image and
    labels share a shape, (H, W) or (D, H, W); returns uint8 RGB of that
    shape + (3,)."""
    from scipy.ndimage import sobel

    image = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    labels = np.clip(np.asarray(labels).astype(np.int64), 0, NUM_CLASSES - 1)
    if image.shape != labels.shape:
        raise ValueError(f"image {image.shape} vs labels {labels.shape}")
    colors = class_color_map().astype(np.float32)
    im = np.repeat((image * 255.0)[..., None], 3, axis=-1)
    colored = np.where((labels > 0)[..., None], colors[labels], im)
    out = colored * overlay_coef + im * (1.0 - overlay_coef)
    if boundaries:
        bmap = np.zeros(labels.shape, np.int64)
        for i in range(1, NUM_CLASSES):
            m = (labels == i).astype(np.float32)
            if not m.any():
                continue
            mag = np.zeros_like(m)
            for ax in range(labels.ndim):
                mag += np.abs(sobel(m, axis=ax, mode="constant"))
            bmap = np.where((mag > 0) & (bmap == 0), i, bmap)
        out = np.where((bmap > 0)[..., None], colors[bmap], out)
    return np.clip(out, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> the bytes of an 8-bit grey or RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)  # filter 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(np.ascontiguousarray(rows).tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_grid_png(path, grid: np.ndarray) -> None:
    """Write `grid` ((H, W) or (H, W, 3) uint8) as a PNG file."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(encode_png(grid))
