"""NIfTI-1 reader and writer (pure numpy + gzip).

A copy of the pure-Python codec of `jointimagegeneration_tpu/data/nifti.py`
(without its native library).  The writer: a 348-byte header plus the 4-byte
extension flag, voxel data at offset 352 in Fortran order, gzip level 1 for
`.nii.gz`.  The reader: either byte order, the magics `n+1` and `ni1`, every
datatype code of `_DTYPES`, `scl_slope` / `scl_inter` (the data then float32),
the voxels returned in C order on the reversed header axes and in the
machine's byte order (torch takes no other).
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["read_nifti", "write_nifti", "save_label_volume", "save_image_volume"]

_DTYPES = {  # NIfTI-1 datatype codes
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open(path, mode: str):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode, compresslevel=1)
    return open(p, mode)


def read_nifti(path) -> Tuple[np.ndarray, dict]:
    """(data, {"spacing", "affine"}): `data` indexed [..., z, y, x] (the
    reversed header axes, so axis 0 of a 3D volume is depth), `spacing` in
    header order (dx, dy, dz), `affine` the 4x4 sform or None without one."""
    with _open(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        endian = "<"
        if struct.unpack("<i", hdr[0:4])[0] != 348:
            if struct.unpack(">i", hdr[0:4])[0] != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            endian = ">"
        magic = hdr[344:348]
        if magic not in (b"n+1\x00", b"ni1\x00"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        dim = struct.unpack(endian + "8h", hdr[40:56])
        shape = dim[1:1 + dim[0]]
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        vox_offset = int(struct.unpack(endian + "f", hdr[108:112])[0])
        scl_slope, scl_inter = struct.unpack(endian + "2f", hdr[112:120])
        sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
        srow = np.frombuffer(hdr[280:328], dtype=endian + "f4").reshape(3, 4)
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        f.read(max(vox_offset - 348, 0))
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
    # Fortran voxel order (x fastest) is C order on the reversed dims
    data = data.reshape(shape[::-1]).astype(dtype.newbyteorder("="))
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        data = data.astype(np.float32) * (scl_slope if scl_slope != 0.0 else 1.0) + scl_inter
    affine = np.vstack([srow, [0, 0, 0, 1]]).astype(np.float32) if sform_code > 0 else None
    return data, {"spacing": tuple(float(p) for p in pixdim[1:1 + min(dim[0], 3)]), "affine": affine}


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
