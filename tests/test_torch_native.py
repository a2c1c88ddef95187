"""PyTorch port: the native data route (`data/native.py`, `csrc/nifti_native.cc`), on the CPU.

Every entry point against its plain numpy version, bit for bit: the read over
every datatype code, `.nii` and `.nii.gz`, both byte orders, scaled and not,
3D and 4D, `n+1` and `ni1`, with spacing and affine; the write's
decompressed bytes; the window at the clip edges and on float64; the remap on
uint8, int16 and float segmentations with a non-integer id and ids >= 256;
the one-hot with out-of-range labels.  The JAX native library
(`native/nifti_native.cc`, built into a temporary directory with its
Makefile's flags; nothing under `native/` is written) agrees where the
port's contract says it does, and departs in three stated places, asserted
here: it reads float32 without the affine, multiplies by 1/W in the window
(one ulp), and truncates a float id before its lookup.  Every port dataset's
items on the native route equal those on the numpy route and the JAX
datasets' on their pure route.  Two threads read at once as one does; a file
the C reader leaves to numpy is counted; a failed build raises with the
compiler's output; `cli.sample`'s writer pool writes what a synchronous
write writes and raises a failed write.
"""

import gzip
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jointimagegeneration_tpu.data.datasets as jds
import jointimagegeneration_tpu.data.native as jnative
from jointimagegeneration_torch.cli import sample as tsample
from jointimagegeneration_torch.data import classes as tclasses
from jointimagegeneration_torch.data import datasets as tds
from jointimagegeneration_torch.data import generic as tgeneric
from jointimagegeneration_torch.data import native
from jointimagegeneration_torch.data import nifti as tnifti
from jointimagegeneration_torch.data import transforms as ttf
from jointimagegeneration_torch.ops.cuda import build
from jointimagegeneration_tpu.data.classes import TOTALSEG_DESIGNATED_LABELS

from test_torch_data import DTYPES, _assert_items_equal, _big_endian_copy, _dataset_pairs, write_cases

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def counted():
    native.reset_counts()
    yield native
    native.reset_counts()


def _bits(a: np.ndarray) -> np.ndarray:
    """The array's bytes, so NaN payloads and signed zeros compare too."""
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.dtype.isnative and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _assert_read_same(path, counted) -> np.ndarray:
    before = counted.counts()["handed_over"]
    got, ginfo = native.read_nifti_native(path)
    want, winfo = tnifti.read_nifti(path)
    _assert_same(got, want)
    assert got.flags.writeable and got.flags.c_contiguous
    assert ginfo["spacing"] == winfo["spacing"]
    if winfo["affine"] is None:
        assert ginfo["affine"] is None
    else:
        _assert_same(ginfo["affine"], winfo["affine"])
    assert counted.counts()["handed_over"] == before, "the C reader left a supported file to numpy"
    return got


def _gzip_copy(src: Path, dst: Path) -> None:
    dst.write_bytes(gzip.compress(src.read_bytes(), compresslevel=1))


def _patch_header(path: Path, fmt: str, offset: int, *values) -> None:
    raw = bytearray(path.read_bytes())
    struct.pack_into(fmt, raw, offset, *values)
    path.write_bytes(bytes(raw))


AFFINE = np.array([[0.7, 0.1, 0.0, -90.5], [0.0, 0.8, 0.05, 12.25], [0.0, 0.0, 2.5, 3.0], [0, 0, 0, 1]], np.float32)


def _volume(dtype, shape=(4, 5, 7), seed: int = 1) -> np.ndarray:
    """Values over the dtype's range, its extremes included."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        data = (rng.standard_normal(shape) * 300).astype(dtype)
        data.flat[:4] = [np.finfo(dtype).max, -0.0, np.finfo(dtype).tiny, -np.finfo(dtype).eps]
        return data
    info = np.iinfo(dtype)
    data = rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    data.flat[:2] = [info.min, info.max]
    return data


# --- read --------------------------------------------------------------------

@pytest.mark.parametrize("order", ["little", "big"])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_read_matches_plain(tmp_path, counted, dtype, suffix, order):
    """The stored dtype in the machine's order, the spacing and the affine."""
    data = _volume(dtype)
    path = tmp_path / "v.nii"
    tnifti.write_nifti_plain(path, data, spacing=(0.7, 0.8, 2.5), affine=AFFINE)
    if order == "big":
        _big_endian_copy(path, tmp_path / "be.nii")
        path = tmp_path / "be.nii"
    if suffix == ".nii.gz":
        _gzip_copy(path, tmp_path / "v.nii.gz")
        path = tmp_path / "v.nii.gz"
    got = _assert_read_same(path, counted)
    np.testing.assert_array_equal(got, data)
    assert counted.counts()["read"] == 1


@pytest.mark.parametrize("order", ["little", "big"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_read_scaled_matches_plain(tmp_path, counted, dtype, order):
    """scl_slope / scl_inter: float32 (float)v * slope + inter, two roundings
    as numpy's, with slopes and offsets that round."""
    data = _volume(dtype, (3, 6, 5), seed=2)
    path = tmp_path / "v.nii"
    tnifti.write_nifti_plain(path, data)
    for slope, inter in ((0.1, 1e-3), (2.5, -3.0), (0.0, 7.3), (1.0, -1024.0), (-1.7, 0.0)):
        _patch_header(path, "<2f", 112, slope, inter)
        read = path
        if order == "big":
            _big_endian_copy(path, tmp_path / "be.nii")
            read = tmp_path / "be.nii"
        _gzip_copy(read, tmp_path / "v.nii.gz")
        for p in (read, tmp_path / "v.nii.gz"):
            assert _assert_read_same(p, counted).dtype == np.float32


@pytest.mark.parametrize("case", ["ni1", "4d", "5d", "no_sform", "unit_slope", "zero_slope", "vox_offset_400",
                                  "vox_offset_below_348", "empty_axis", "long_axes"])
def test_read_header_variants_match_plain(tmp_path, counted, case):
    rng = np.random.default_rng(3)
    shape = {"4d": (2, 3, 4, 5), "5d": (2, 1, 3, 4, 5), "empty_axis": (3, 0, 4), "long_axes": (2, 300, 2)}
    data = (rng.standard_normal(shape.get(case, (3, 4, 5))) * 50).astype(np.int16)
    path = tmp_path / "v.nii"
    tnifti.write_nifti_plain(path, data, spacing=(0.9, 0.6, 3.0))
    if case == "ni1":
        raw = bytearray(path.read_bytes())
        raw[344:348] = b"ni1\x00"
        path.write_bytes(bytes(raw))
    elif case == "no_sform":
        _patch_header(path, "<h", 254, 0)
    elif case == "unit_slope":
        _patch_header(path, "<2f", 112, 1.0, 0.0)
    elif case == "zero_slope":
        _patch_header(path, "<2f", 112, 0.0, 0.0)
    elif case == "vox_offset_400":  # 48 bytes of extension before the voxels
        raw = path.read_bytes()
        path.write_bytes(raw[:352] + bytes(range(48)) + raw[352:])
        _patch_header(path, "<f", 108, 400.0)
    elif case == "vox_offset_below_348":  # the voxels then follow the 348 bytes
        raw = path.read_bytes()
        path.write_bytes(raw[:348] + raw[352:])
        _patch_header(path, "<f", 108, 0.0)
    for p in (path, tmp_path / "v.nii.gz"):
        if p.suffix == ".gz":
            _gzip_copy(path, p)
        got = _assert_read_same(p, counted)
        assert got.dtype == np.int16
        if case not in ("vox_offset_below_348",):
            np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("case", ["datatype", "magic", "short_header", "short_voxels", "sizeof_hdr", "missing",
                                  "not_gzip", "dim0_zero", "dim0_eight"])
def test_read_hands_over_what_it_does_not_decode(tmp_path, counted, case):
    """A file the C reader does not decode goes to the numpy reader, which
    decodes it or raises its own error, and the hand-over is counted."""
    path = tmp_path / "v.nii"
    tnifti.write_nifti_plain(path, np.arange(24, dtype=np.int16).reshape(2, 3, 4))
    raw = bytearray(path.read_bytes())
    if case == "datatype":
        struct.pack_into("<h", raw, 70, 32)  # complex64: not in the table
    elif case == "magic":
        raw[344:348] = b"xx1\x00"
    elif case == "short_header":
        raw = raw[:200]
    elif case == "short_voxels":
        raw = raw[:360]
    elif case == "sizeof_hdr":
        struct.pack_into("<i", raw, 0, 999)
    elif case == "dim0_zero":  # numpy reads a 0-d volume
        struct.pack_into("<h", raw, 40, 0)
    elif case == "dim0_eight":
        struct.pack_into("<h", raw, 40, 8)
    path.write_bytes(bytes(raw))
    if case == "not_gzip":  # a .gz name on an uncompressed file
        path = path.rename(tmp_path / "v.nii.gz")
    if case == "missing":
        path = tmp_path / "absent.nii.gz"
    try:
        want = tnifti.read_nifti(path)
    except Exception as e:
        with pytest.raises(type(e), match=None):
            native.read_nifti_native(path)
    else:
        got = native.read_nifti_native(path)
        _assert_same(got[0], want[0])
        assert got[1]["spacing"] == want[1]["spacing"]
    assert counted.counts() == {"read": 1, "write": 0, "window": 0, "remap": 0, "one_hot": 0, "handed_over": 1}


# --- write -------------------------------------------------------------------

WRITE_CASES = {
    "int16": lambda rng: (rng.standard_normal((5, 6, 7)) * 500).astype(np.int16),
    "uint8": lambda rng: rng.integers(0, 12, (5, 6, 7), dtype=np.uint8),
    "float32": lambda rng: rng.random((5, 6, 7), dtype=np.float32),
    "float64_4d": lambda rng: rng.standard_normal((2, 3, 4, 5)),
    "uint64": lambda rng: rng.integers(0, 2**64 - 1, (3, 4, 5), dtype=np.uint64),
    "bool": lambda rng: rng.random((4, 5, 6)) > 0.5,
    "float16": lambda rng: rng.random((4, 5, 6)).astype(np.float16),
    "big_endian_int16": lambda rng: np.arange(60, dtype=">i2").reshape(3, 4, 5),
    "transposed": lambda rng: rng.random((6, 5, 4), dtype=np.float32).transpose(2, 1, 0),
}


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_write_payload_matches_plain(tmp_path, counted, case, suffix):
    """The same header and voxel bytes as the numpy writer, read back equal."""
    data = WRITE_CASES[case](np.random.default_rng(4))
    for spacing, affine in ((None, None), ((0.7, 0.8, 2.5), None), ((1.5, 1.5, 3.0), AFFINE)):
        native.write_nifti_native(tmp_path / f"n{suffix}", data, spacing=spacing, affine=affine)
        tnifti.write_nifti_plain(tmp_path / f"p{suffix}", data, spacing=spacing, affine=affine)
        read = (lambda p: gzip.open(p).read()) if suffix == ".nii.gz" else (lambda p: p.read_bytes())
        payload = read(tmp_path / f"n{suffix}")
        assert payload == read(tmp_path / f"p{suffix}")
        got, _ = tnifti.read_nifti(tmp_path / f"n{suffix}")
        np.testing.assert_array_equal(got, tnifti.writable(data))
    assert counted.counts()["write"] == 3


def test_write_nifti_goes_through_the_native_writer(tmp_path, counted):
    """`write_nifti` and the two `save_*` helpers write natively; a write
    that fails raises the OSError the plain writer raises."""
    vol = np.random.default_rng(5).random((3, 4, 5), dtype=np.float32)
    tnifti.write_nifti(tmp_path / "a.nii.gz", vol)
    tnifti.save_image_volume(tmp_path / "b.nii.gz", vol)
    tnifti.save_label_volume(tmp_path / "c.nii.gz", (vol * 10).astype(np.int64))
    assert counted.counts()["write"] == 3
    np.testing.assert_array_equal(tnifti.read_nifti(tmp_path / "c.nii.gz")[0], (vol * 10).astype(np.uint8))
    (tmp_path / "dir.nii.gz").mkdir()
    for target, error in ((tmp_path / "missing" / "v.nii.gz", FileNotFoundError),
                          (tmp_path / "dir.nii.gz", IsADirectoryError)):
        with pytest.raises(error):
            tnifti.write_nifti_plain(target, vol)
        with pytest.raises(error, match=str(target.name)):
            tnifti.write_nifti(target, vol)


# --- window, remap, one-hot --------------------------------------------------

def _window_input(kind: str) -> np.ndarray:
    rng = np.random.default_rng(6)
    if kind == "int16":
        return (rng.standard_normal((6, 20, 24)) * 400).astype(np.int16)
    if kind == "uint8":
        return rng.integers(0, 255, (4, 9, 9), dtype=np.uint8)
    if kind == "bool":
        return rng.random((4, 5)) > 0.5
    x = rng.standard_normal((5, 7, 9)) * 400
    x.flat[:9] = [-120.0, 240.0, -120.0000001, 240.00001, np.nan, np.inf, -np.inf, -0.0, 1e300]
    if kind == "float32":
        return x.astype(np.float32)
    if kind == "float32_strided":
        return x.astype(np.float32)[:, ::2, 1:]
    return x


@pytest.mark.parametrize("window", [(60.0, 360.0), (60, 360), (0.0, 2.0), (40.0, 400.0), (-1000.0, 0.5)])
@pytest.mark.parametrize("kind", ["int16", "uint8", "bool", "float32", "float32_strided", "float64"])
def test_window_norm_matches_plain(counted, kind, window):
    """At and past the clip edges (L +- W/2, NaN, infinities, -0.0, a float64
    past float32's range) and on float64 input."""
    x = _window_input(kind)
    _assert_same(native.window_norm_native(x, *window), ttf.window_norm(x, *window))
    assert counted.counts()["window"] == 1


def test_window_norm_refuses_a_promoting_window():
    """numpy computes in float64 with a float64 window; the native window does not."""
    x = np.zeros((2, 3), np.int16)
    assert ttf.window_norm(x, np.float64(60.0), 360.0).dtype == np.float64
    with pytest.raises(TypeError, match="Python numbers"):
        native.window_norm_native(x, np.float64(60.0), 360.0)


def _segmentation(dtype) -> np.ndarray:
    rng = np.random.default_rng(7)
    ids = np.array(TOTALSEG_DESIGNATED_LABELS + (0, 7, 200, 255), np.int64)
    seg = rng.choice(ids, size=(5, 8, 9)).astype(dtype)
    if np.dtype(dtype).kind in "if" and np.dtype(dtype).itemsize > 1:
        seg.flat[:4] = [261, 256 + 5, 1000, -5]  # ids >= 256 (261 and 256 + 5 wrap onto ids), a negative one
    if np.dtype(dtype).kind == "f":
        seg.flat[4:8] = [5.5, 104.25, np.nan, -0.0]  # non-integer ids
    return seg


@pytest.mark.parametrize("tumor", [None, "uint8", "float32"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.float64, np.int64, np.uint16, np.int8],
                         ids=lambda d: np.dtype(d).name)
def test_remap_labels_matches_plain(counted, dtype, tumor):
    seg = _segmentation(dtype)
    mask = None
    if tumor is not None:
        mask = (np.random.default_rng(8).random(seg.shape) > 0.8).astype(tumor)
        if tumor == "float32":
            mask.flat[:3] = [np.nan, -1.0, 0.5]
    _assert_same(native.remap_labels_native(seg, mask), tclasses.remap_totalseg_labels(seg, mask))
    assert counted.counts()["remap"] == 1


def test_remap_labels_refuses_a_mask_of_another_shape():
    with pytest.raises(ValueError, match="tumour mask"):
        native.remap_labels_native(np.zeros((2, 3), np.uint8), np.zeros((3, 2), np.uint8))


@pytest.mark.parametrize("num_classes", [1, 4, 12])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8, np.int64, np.int16, np.uint64, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_one_hot_matches_plain(counted, dtype, num_classes):
    """Labels out of [0, C) clipped into it, as numpy clips them."""
    rng = np.random.default_rng(9)
    labels = rng.integers(0, 100, (4, 6, 5)).astype(dtype)
    if np.dtype(dtype).kind == "i":
        labels.flat[:3] = [-3, num_classes, np.iinfo(dtype).min]
    _assert_same(native.one_hot_native(labels, num_classes), ttf.one_hot_np(labels, num_classes))
    assert counted.counts()["one_hot"] == 1


def test_one_hot_refuses_float_labels():
    with pytest.raises(IndexError):
        ttf.one_hot_np(np.zeros(3, np.float32), 4)
    with pytest.raises(TypeError, match="integer labels"):
        native.one_hot_native(np.zeros(3, np.float32), 4)


# --- the JAX native library --------------------------------------------------

@pytest.fixture(scope="session")
def jax_library(tmp_path_factory) -> Path:
    """native/nifti_native.cc compiled with its Makefile's flags into a
    temporary directory (nothing under native/ is written, so
    tests/test_native.py's library is never raced)."""
    out = tmp_path_factory.mktemp("jax_native") / "libjig_native.so"
    subprocess.run(["c++", "-O3", "-fPIC", "-std=c++17", "-Wall", str(ROOT / "native" / "nifti_native.cc"), "-o",
                    str(out), "-shared", "-lz"], check=True, capture_output=True)
    return out


@pytest.fixture
def jax_native(jax_library, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB_PATH", jax_library)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.native_available()
    return jnative


@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
def test_jax_library_read_departs_only_in_dtype_and_affine(tmp_path, jax_native, dtype):
    """The JAX reader returns float32 and no affine; the values agree with
    the port's, the scaled ones bit for bit."""
    data = _volume(dtype, (4, 6, 8))
    path = tmp_path / "v.nii.gz"
    tnifti.write_nifti_plain(path, data, spacing=(0.7, 0.8, 2.5))
    got, ginfo = native.read_nifti_native(path)
    want, winfo = jax_native.read_nifti_native(path)
    assert got.dtype == np.dtype(dtype) and want.dtype == np.float32  # departure: the stored dtype kept
    assert winfo["affine"] is None and ginfo["affine"] is not None  # departure: the affine kept
    np.testing.assert_array_equal(got.astype(np.float32), want)
    assert ginfo["spacing"] == winfo["spacing"]
    _patch_header_gz(path, 0.1, 1e-3)
    got, _ = native.read_nifti_native(path)
    want, _ = jax_native.read_nifti_native(path)
    _assert_same(got, want)


def _patch_header_gz(path: Path, slope: float, inter: float) -> None:
    raw = bytearray(gzip.open(path).read())
    struct.pack_into("<2f", raw, 112, slope, inter)
    path.write_bytes(gzip.compress(bytes(raw)))


def test_jax_library_window_multiplies_by_the_reciprocal(jax_native):
    """The JAX window multiplies by 1/W: one float32 ulp from the port's
    divide on some voxels (departure), equal elsewhere."""
    x = _window_input("int16")
    got = native.window_norm_native(x)
    want = jax_native.window_norm_native(x)
    assert got.dtype == want.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() == 1 and (ulps > 0).any()
    _assert_same(got, ttf.window_norm(x))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_jax_library_remap_truncates_float_ids(jax_native, dtype):
    """On integer ids (ids >= 256 included) the two agree; the JAX library
    truncates a float id (5.5 -> 5, liver) where numpy's equality gives 0
    (departure)."""
    seg = _segmentation(dtype)
    tumor = (np.random.default_rng(8).random(seg.shape) > 0.8).astype(np.uint8)
    got = native.remap_labels_native(seg, tumor)
    want = jax_native.remap_labels_native(seg, tumor, TOTALSEG_DESIGNATED_LABELS, tclasses.NUM_CLASSES - 1)
    differ = got != want
    if dtype == np.float32:
        fractional = (np.mod(seg, 1) != 0) & np.isfinite(seg) & (tumor == 0)
        assert fractional.any() and np.array_equal(differ, fractional & (want != 0))
        assert differ.any()
        assert np.all(got[fractional] == 0)
    else:
        assert not differ.any()


def test_jax_library_one_hot_and_write_agree(tmp_path, jax_native):
    labels = np.random.default_rng(10).integers(-2, 15, (4, 5, 6)).astype(np.int32)
    _assert_same(native.one_hot_native(labels, 12), jax_native.one_hot_native(labels, 12))
    vol = np.random.default_rng(11).random((4, 5, 6), dtype=np.float32)
    for name, spacing in (("a.nii.gz", (0.7, 0.8, 2.5)), ("b.nii", None)):
        native.write_nifti_native(tmp_path / f"port_{name}", vol, spacing=spacing)
        assert jax_native.write_nifti_native(tmp_path / f"jax_{name}", vol, spacing=spacing)
        read = (lambda p: gzip.open(p).read()) if name.endswith(".gz") else (lambda p: p.read_bytes())
        assert read(tmp_path / f"port_{name}") == read(tmp_path / f"jax_{name}")


# --- datasets ----------------------------------------------------------------

@pytest.fixture
def port_plain(monkeypatch):
    """The port's datasets on the numpy route."""
    monkeypatch.setattr(tds, "native_available", lambda: False)


@pytest.mark.parametrize("kind", ["ruijin", "ruijin_max_size", "ruijin_slices", "ruijin_3d", "nnunet"])
def test_dataset_items_equal_on_both_routes_and_to_jax(tmp_path, monkeypatch, counted, kind):
    """Each item on the native route equals the numpy route's bit for bit,
    and the JAX dataset's on its pure route (ruijin_3d's linearly resized CT
    within 1e-6, as in test_torch_data)."""
    fx = write_cases(tmp_path)
    make, close = _dataset_pairs(fx)[kind]
    monkeypatch.setattr(jds, "native_available", lambda: False)
    for split in ("train", "val"):
        ds, want_ds = make(tds, split), make(jds, split)
        native_items = [ds[i] for i in range(len(ds))]
        with monkeypatch.context() as m:
            m.setattr(tds, "native_available", lambda: False)
            plain_items = [ds[i] for i in range(len(ds))]
        for i, item in enumerate(native_items):
            _assert_items_equal(item, plain_items[i])
            _assert_items_equal(item, want_ds[i], close)
    c = counted.counts()
    assert c["read"] > 0 and c["handed_over"] == 0
    assert c["remap"] > 0 if kind != "nnunet" else c["remap"] == 0
    assert c["window"] > 0 if kind in ("ruijin_slices", "ruijin_3d", "nnunet") else c["window"] == 0


def test_generic_and_synthetic_items_equal_on_both_routes(tmp_path, monkeypatch, counted):
    """`FileListDataset`'s NIfTI reads, `TransformedPairDataset`'s one-hot
    and the synthetic slices' window (float64 in, Python ints as the window)."""
    rng = np.random.default_rng(12)
    for i in range(3):
        tnifti.write_nifti(tmp_path / f"v{i}.nii.gz", (rng.standard_normal((3, 4, 5)) * 9).astype(np.int16))

    class Pairs:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"image": rng.random((4, 5), dtype=np.float32), "label": np.arange(20).reshape(4, 5) % 7 - 1}

    files = tgeneric.FileListDataset(str(tmp_path / "*.nii.gz"))
    synth = tds.SyntheticSliceDataset(num_cases=2, slice_shape=(16, 12), depth=3, num_classes=5,
                                      include_volumes=True)
    items = [files[i] for i in range(3)] + [synth[i] for i in range(2)]
    rng = np.random.default_rng(13)
    pairs = [tgeneric.TransformedPairDataset(Pairs(), num_classes=5)[i] for i in range(3)]
    with monkeypatch.context() as m:
        m.setattr(tds, "native_available", lambda: False)
        plain = [files[i] for i in range(3)] + [synth[i] for i in range(2)]
        rng = np.random.default_rng(13)
        plain_pairs = [tgeneric.TransformedPairDataset(Pairs(), num_classes=5)[i] for i in range(3)]
    for got, want in zip(items + pairs, plain + plain_pairs):
        _assert_items_equal(got, want)
    c = counted.counts()
    assert c["read"] == 3 and c["one_hot"] == 3 and c["window"] == 2 and c["handed_over"] == 0


# --- threads, the build ------------------------------------------------------

def test_two_threads_read_as_one(tmp_path, counted):
    """The reader keeps no shared state: two threads reading different files
    at once get what one thread reads."""
    rng = np.random.default_rng(14)
    paths = []
    for i, dtype in enumerate((np.int16, np.uint8)):
        p = tmp_path / f"v{i}.nii.gz"
        tnifti.write_nifti(p, rng.integers(0, 120, (8, 40, 48)).astype(dtype))
        paths.append(p)
    want = [tnifti.read_nifti(p)[0] for p in paths]
    barrier, results = threading.Barrier(2), [[], []]

    def read(k):
        barrier.wait()
        for _ in range(25):
            results[k].append(native.read_nifti_native(paths[k])[0])

    threads = [threading.Thread(target=read, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in range(2):
        assert len(results[k]) == 25
        for got in results[k]:
            _assert_same(got, want[k])
    assert counted.counts()["read"] == 50 and counted.counts()["handed_over"] == 0


def test_build_puts_the_library_in_build_kernels():
    """The host target: built at first use under a hashed name in
    build/kernels/, with the compiler and flags of the host C++ route."""
    native.native_available()
    path = build._library_path(native.SOURCE)
    assert path.parent == ROOT / "build" / "kernels" and path.name.startswith("nifti_native-") and path.exists()
    cmd = build._command(native.SOURCE, path)
    assert cmd[0] == build.cxx_path() and cmd[-1] == "-lz"
    assert {"-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared"} <= set(cmd)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A stand-in compiler through $CXX that fails: the build raises with
    its output, and the native route raises with it (no fall-back)."""
    fake = tmp_path / "fake-c++"
    fake.write_text("#!/bin/sh\necho 'stand-in compiler: zlib.h: No such file or directory' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="stand-in compiler: zlib.h"):
        build.build_all([native.SOURCE])
    with pytest.raises(RuntimeError, match="fake-c\\+\\+ failed for nifti_native"):
        native.read_nifti_native(tmp_path / "any.nii.gz")
    with pytest.raises(RuntimeError, match="stand-in compiler"):
        tds.read_nifti(tmp_path / "any.nii.gz")
    monkeypatch.setenv("CXX", str(tmp_path / "absent-c++"))
    with pytest.raises(RuntimeError, match="could not be started"):
        build.build_all([native.SOURCE])
    assert not list((tmp_path / "kernels").iterdir())


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Two builds of the same library at once (as several test processes
    start): each compiles to a file of its own and renames it into place."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    errors = []

    def run():
        try:
            build.build_all([native.SOURCE])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert [p.name for p in (tmp_path / "kernels").iterdir()] == [build._library_path(native.SOURCE).name]


# --- the sampler's writer pool -----------------------------------------------

def _two_stage_cfg(out: Path) -> dict:
    return {"stage": "two_stage", "output_path": str(out), "seed": 3, "n_cases": 3, "mask_steps": 2,
            "ddim_steps": 2, "volume_shape": [4, 16, 16], "chunk": 2, "slices": 2, "device": "cpu",
            "fresh_init_noise": 0.02,
            "stage1": {"num_classes": 4, "time_steps": 20, "bf16": False,
                       "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                                       "num_head_channels": 4, "num_res_blocks": 1},
                       "dataset": {"volume_shape": [4, 16, 16]}},
            "stage2": {"slice_size": 16, "timesteps": 100, "bf16": False,
                       "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2],
                                                  "attention_resolutions": [2], "num_head_channels": 4,
                                                  "num_res_blocks": 1}}}}


def test_two_stage_writer_pool_writes_what_a_synchronous_write_writes(tmp_path, counted, capsys):
    """`cli.sample.run`'s two_stage writes each case in its pool of two
    threads: the files equal, payload for payload, what the plain writer
    writes synchronously from the returned arrays; a write made to fail (a
    directory where image.nii.gz goes) raises from `run`."""
    res = tsample.run(_two_stage_cfg(tmp_path / "s"))
    assert counted.counts()["write"] == 6 and res["ct"].shape == (3, 2, 16, 16)
    for j in range(3):
        cdir = tmp_path / "s" / f"case_{j:04d}"
        for name, vol in (("image.nii.gz", res["ct"][j].astype(np.float32)),
                          ("pred.nii.gz", res["labels"][j, :2].astype(np.uint8))):
            tnifti.write_nifti_plain(tmp_path / name, vol)
            assert gzip.open(cdir / name).read() == gzip.open(tmp_path / name).read()
            _assert_same(tnifti.read_nifti(cdir / name)[0], vol)
        assert {p.name for p in cdir.iterdir()} == {"image.nii.gz", "image.png", "pred.nii.gz", "pred.png",
                                                    "overlay.png"}
    (tmp_path / "f" / "case_0001" / "image.nii.gz").mkdir(parents=True)
    with pytest.raises(IsADirectoryError, match="image.nii.gz"):
        tsample.run(_two_stage_cfg(tmp_path / "f"))
    assert (tmp_path / "f" / "case_0002" / "pred.nii.gz").exists()  # the other cases were written
