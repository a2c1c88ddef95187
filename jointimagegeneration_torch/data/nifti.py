"""NIfTI-1 writer (pure numpy + gzip).

A copy of the pure-Python `write_nifti` path of
`jointimagegeneration_tpu/data/nifti.py` (without its native library): a
348-byte header plus the 4-byte extension flag, voxel data at offset 352 in
Fortran order, gzip level 1 for `.nii.gz`.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["write_nifti", "save_label_volume", "save_image_volume"]

_DTYPE_CODES = {
    np.dtype(np.uint8): 2,
    np.dtype(np.int16): 4,
    np.dtype(np.int32): 8,
    np.dtype(np.float32): 16,
    np.dtype(np.float64): 64,
    np.dtype(np.int8): 256,
    np.dtype(np.uint16): 512,
    np.dtype(np.uint32): 768,
    np.dtype(np.int64): 1024,
    np.dtype(np.uint64): 1280,
}


def _open(path, mode: str):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode, compresslevel=1)
    return open(p, mode)


def write_nifti(path, data: np.ndarray, spacing: Optional[Tuple[float, ...]] = None, affine=None) -> None:
    """Write a NIfTI-1 (.nii or .nii.gz) volume.  `data` is indexed
    [..., z, y, x]; header dims are the reversed shape.  `spacing` is in world
    order (dx, dy, dz)."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    ndim = data.ndim
    shape = data.shape
    spacing = tuple(spacing or (1.0,) * min(ndim, 3))

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [ndim] + list(shape[::-1]) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    pixdim = [1.0] + list(spacing) + [1.0] * (7 - len(spacing))
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    if affine is None:
        affine = np.eye(4, dtype=np.float32)
        for i in range(min(3, len(spacing))):
            affine[i, i] = spacing[i]
    struct.pack_into("<h", hdr, 252, 1)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *np.asarray(affine, np.float32)[:3].reshape(-1))
    hdr[344:348] = b"n+1\x00"

    # C-order ravel of (..., z, y, x) is Fortran order of the (x, y, z) dims
    payload = np.ascontiguousarray(data).reshape(-1)
    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(payload.tobytes())


def save_label_volume(path, labels: np.ndarray, spacing=None) -> None:
    """Integer (D, H, W) label volume -> uint8 NIfTI (the pred.nii.gz contract)."""
    write_nifti(path, np.asarray(labels).astype(np.uint8), spacing=spacing)


def save_image_volume(path, image: np.ndarray, spacing=None) -> None:
    write_nifti(path, np.asarray(image).astype(np.float32), spacing=spacing)
