"""ctypes bindings of the native data route (`csrc/nifti_native.cc`).

The port's counterpart of `jointimagegeneration_tpu/data/native.py`: the NIfTI
read and write, CT windowing, the TotalSegmentator label remap and the
one-hot in C++, each called through `ctypes.CDLL`, which releases the GIL for
the call, so the loader's threads decode in parallel and the sampler's writer
threads deflate while the device works.  The library is built at first use
into `build/kernels/` by `ops/cuda/build.py` (the host compiler, `-lz`); a
failed build raises with the compiler's output.

Each entry point returns, call for call, what its plain numpy version
returns: the same dtype, shape and bits.

  * `read_nifti_native` = `data/nifti.read_nifti`: the stored dtype in the
    machine's byte order (float32 when `scl_slope` / `scl_inter` scale it),
    the spacing and the sform affine.  The header is read and parsed once,
    the array allocated here from it, and the voxels inflated straight into
    it.  A file the C reader does not decode (a datatype outside its table,
    no NIfTI-1 magic, a `dim[0]` outside 1..7, a short or unreadable file)
    is handed to `read_nifti`, which decodes it or raises its own error;
    each hand-over is counted in `read_nifti_native.handed_over`.
  * `write_nifti_native` = `data/nifti.write_nifti_plain`: the same header
    and voxel bytes (the gzip members differ: Python's carries the file name
    and mtime); an error raises OSError.
  * `window_norm_native` = `data/transforms.window_norm` (a divide by W);
  * `remap_labels_native` = `data/classes.remap_totalseg_labels` (equality
    with each id, whatever the dtype);
  * `one_hot_native` = `data/transforms.one_hot_np` in float32.

Every entry point counts its calls in its `calls` attribute (`reset_counts`
sets them to 0), as the CUDA kernels' wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops.cuda import build
from .classes import NUM_CLASSES, TOTALSEG_DESIGNATED_LABELS
from .nifti import _DTYPES, _DTYPE_CODES, header_bytes, read_nifti, writable

__all__ = ["SOURCE", "native_available", "read_nifti_native", "write_nifti_native", "window_norm_native",
           "remap_labels_native", "one_hot_native", "reset_counts", "counts"]

SOURCE = "nifti_native"  # csrc/nifti_native.cc
WRITE_LEVEL = 1  # gzip level of .nii.gz writes, as the plain writer's

_P = ctypes.c_void_p
_I32, _I64, _F32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float


class _Header(ctypes.Structure):
    _fields_ = [("ndim", _I32), ("datatype", _I32), ("dims", _I64 * 7), ("pixdim", _F32 * 8),
                ("scl_slope", _F32), ("scl_inter", _F32), ("sform_code", _I32), ("big_endian", _I32),
                ("srow", _F32 * 12)]


_SIGNATURES = {
    "jig_open_nifti": (_P, [ctypes.c_char_p, _I32, ctypes.POINTER(_Header)]),
    "jig_read_voxels": (_I32, [_P, _I32, _I64, _P, _I32, _F32, _F32]),
    "jig_close_nifti": (None, [_P]),
    "jig_write_nifti": (_I32, [ctypes.c_char_p, _I32, _I32, _P, _I64, _P, _I64]),
    "jig_window_norm": (_I32, [_P, _I32, _P, _I64, _F32, _F32]),
    "jig_remap_labels": (_I32, [_P, _I32, _P, _I32, _P, _I64, _P, _I32, _I32]),
    "jig_one_hot": (_I32, [_P, _I32, _P, _I64, _I32]),
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()  # the first load, and the counters (the loader's threads bump them at once)
_IDS = np.asarray(TOTALSEG_DESIGNATED_LABELS, np.int32)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = build.load_library(SOURCE)
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _lib = lib
    return _lib


def native_available() -> bool:
    """True once the library is built and loaded (built at first use; a
    failed build raises).  The datasets' routing asks it; a test or a
    measurement patches the datasets' name to False for the plain route."""
    return _library() is not None


def _count(fn, attr: str = "calls") -> None:
    with _lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def _code(a: np.ndarray) -> int:
    return _DTYPE_CODES[a.dtype]


def _coded(a, fallback=np.float32) -> np.ndarray:
    """`a` C-contiguous in a dtype the library takes: bool as uint8 (the same
    bytes), a dtype outside the table as `fallback`."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        return a.view(np.uint8)
    return a if a.dtype in _DTYPE_CODES else a.astype(fallback)


def read_nifti_native(path) -> Tuple[np.ndarray, dict]:
    """`data/nifti.read_nifti` through the C reader (see the module doc)."""
    lib = _library()
    _count(read_nifti_native)
    p = os.fspath(path)
    hdr = _Header()
    handle = lib.jig_open_nifti(os.fsencode(p), int(str(p).endswith(".gz")), ctypes.byref(hdr))
    if not handle:
        return _hand_over(path)
    try:
        shape = tuple(int(hdr.dims[i]) for i in range(hdr.ndim))[::-1]
        slope, inter = float(hdr.scl_slope), float(hdr.scl_inter)
        scaled = slope not in (0.0, 1.0) or inter != 0.0
        out = np.empty(shape, np.float32 if scaled else _DTYPES[hdr.datatype])
        if lib.jig_read_voxels(handle, hdr.datatype, out.size, out.ctypes.data, int(scaled),
                               slope if slope != 0.0 else 1.0, inter):
            return _hand_over(path)
    finally:
        lib.jig_close_nifti(handle)
    affine = None
    if hdr.sform_code > 0:
        affine = np.vstack([np.asarray(hdr.srow, np.float32).reshape(3, 4), [0, 0, 0, 1]]).astype(np.float32)
    spacing = tuple(float(hdr.pixdim[i]) for i in range(1, 1 + min(hdr.ndim, 3)))
    return out, {"spacing": spacing, "affine": affine}


def _hand_over(path) -> Tuple[np.ndarray, dict]:
    _count(read_nifti_native, "handed_over")
    return read_nifti(path)


def write_nifti_native(path, data: np.ndarray, spacing=None, affine=None) -> None:
    """`data/nifti.write_nifti_plain` through the C writer: the same header
    and voxel bytes, deflated at gzip level 1 for `.nii.gz`."""
    lib = _library()
    _count(write_nifti_native)
    data = np.ascontiguousarray(writable(data))
    hdr = header_bytes(data, spacing, affine)
    p = os.fspath(path)
    err = lib.jig_write_nifti(os.fsencode(p), int(str(p).endswith(".gz")), WRITE_LEVEL, hdr, len(hdr),
                              data.ctypes.data, data.nbytes)
    if err:
        raise OSError(err, os.strerror(err), str(p))


def window_norm_native(image: np.ndarray, window_pos: float = 60.0, window_width: float = 360.0) -> np.ndarray:
    """`data/transforms.window_norm`: clip((float32(x) - lo) / W, 0, 1), lo
    = L - W / 2, with L and W Python numbers (numpy then computes in
    float32)."""
    lib = _library()
    _count(window_norm_native)
    lo = window_pos - window_width / 2
    if np.result_type(np.float32, lo, window_width) != np.float32:
        raise TypeError(f"window_norm_native: window {window_pos!r}, {window_width!r} would promote float32; "
                        "pass Python numbers")
    src = _coded(image)
    out = np.empty(src.shape, np.float32)
    lib.jig_window_norm(src.ctypes.data, _code(src), out.ctypes.data, src.size, lo, window_width)
    return out


def remap_labels_native(label: np.ndarray, tumor_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """`data/classes.remap_totalseg_labels`: int32 class ids, the tumour
    class where `tumor_mask` > 0."""
    lib = _library()
    _count(remap_labels_native)
    seg = _coded(label)
    tumor = None if tumor_mask is None else _coded(tumor_mask)
    if tumor is not None and tumor.shape != seg.shape:
        raise ValueError(f"remap_labels_native: tumour mask {tumor.shape} against labels {seg.shape}")
    out = np.empty(seg.shape, np.int32)
    lib.jig_remap_labels(seg.ctypes.data, _code(seg), None if tumor is None else tumor.ctypes.data,
                         0 if tumor is None else _code(tumor), out.ctypes.data, seg.size, _IDS.ctypes.data,
                         len(_IDS), NUM_CLASSES - 1)
    return out


def one_hot_native(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """`data/transforms.one_hot_np` in float32: (..., C), the labels clipped
    into [0, C)."""
    lib = _library()
    _count(one_hot_native)
    labels = np.asarray(labels)
    if labels.dtype.kind not in "biu" or num_classes < 1:
        raise TypeError(f"one_hot_native: integer labels and num_classes >= 1, not {labels.dtype} and "
                        f"{num_classes}")
    src = _coded(labels, np.int64)
    out = np.empty(src.shape + (num_classes,), np.float32)
    lib.jig_one_hot(src.ctypes.data, _code(src), out.ctypes.data, src.size, num_classes)
    return out


_ENTRY_POINTS = (read_nifti_native, write_nifti_native, window_norm_native, remap_labels_native, one_hot_native)


def reset_counts() -> None:
    """Every entry point's `calls`, and the reader's `handed_over`, to 0."""
    with _lock:
        for fn in _ENTRY_POINTS:
            fn.calls = 0
        read_nifti_native.handed_over = 0


def counts() -> dict:
    """{"read", "write", "window", "remap", "one_hot", "handed_over"}."""
    with _lock:
        return {"read": read_nifti_native.calls, "write": write_nifti_native.calls,
                "window": window_norm_native.calls, "remap": remap_labels_native.calls,
                "one_hot": one_hot_native.calls, "handed_over": read_nifti_native.handed_over}


reset_counts()
