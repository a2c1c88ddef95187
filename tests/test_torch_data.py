"""PyTorch port: the real-data layer against the JAX package, on the CPU.

`read_nifti` on the files of both writers (every datatype, big-endian, the
`ni1` magic, `scl_slope` / `scl_inter`, 4D): equal bit for bit.
`resize_volume` against `jax.image.resize` (nearest, linear, cubic; down, up,
non-integer ratios; 3D and 4D): labels equal with their dtype, floats on
[0, 1] data (the windowed CT it resamples) within 1e-5 absolute: the weights
are jax.image's to the last bit or one ulp, the contractions sum in another
order.  `crop_or_pad`, `random_flip`, `remap_totalseg_labels`,
`train_val_split` and `build_transforms` (the same Generator): equal, the
resampled pipeline images within 1e-5.  Every dataset's items over two
epochs and both splits against the JAX dataset on its pure route
(`native_available` patched to False in the JAX module): equal bit for bit,
but for the linearly resized CT of `ruijin_3d`, within 1e-6 for the reason
above.  The port's `DataLoader` first batch against the JAX loader's.
"""

import json
import struct

import jax
import numpy as np
import pytest
import torch

import jointimagegeneration_tpu.data.datasets as jds
from jointimagegeneration_torch.data import classes as tclasses
from jointimagegeneration_torch.data import datasets as tds
from jointimagegeneration_torch.data import nifti as tnifti
from jointimagegeneration_torch.data import pipelines as tpipe
from jointimagegeneration_torch.data import transforms as ttf
from jointimagegeneration_torch.data.loader import DataLoader as TLoader
from jointimagegeneration_tpu.data import classes as jclasses
from jointimagegeneration_tpu.data import nifti as jnifti
from jointimagegeneration_tpu.data import pipelines as jpipe
from jointimagegeneration_tpu.data import transforms as jtf
from jointimagegeneration_tpu.data.loader import DataLoader as JLoader

IDS = (1, 2, 3, 5, 6, 10, 55, 56, 57, 104)
CASE_SHAPE = (6, 20, 24)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_pure(monkeypatch):
    """The JAX datasets on their pure route, as the port's only route."""
    monkeypatch.setattr(jds, "native_available", lambda: False)


def write_cases(root, n: int = 5, shape=CASE_SHAPE, feat=(5, 16), seed: int = 0) -> dict:
    """`n` cases under root/cases/<case>/ ({image, totalseg, crcseg}.nii.gz,
    features.npz) and the same cases as an nnUNet tree under root/nnunet;
    case 1 has no crcseg, case 2 an int16 totalseg.  Returns
    {"index": path of the JSON index, "nnunet": root of the tree}."""
    rng = np.random.default_rng(seed)
    index = {}
    for sub in ("imagesTr", "labelsTr"):
        (root / "nnunet" / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        name = f"case_{i:02d}"
        d = root / "cases" / name
        d.mkdir(parents=True, exist_ok=True)
        img = (rng.standard_normal(shape) * 300).astype(np.int16)
        seg = rng.choice(np.array(IDS + (0, 7, 200), np.uint8), size=shape)
        tumor = (rng.random(shape) > 0.85).astype(np.uint8)
        tnifti.write_nifti(d / "image.nii.gz", img)
        tnifti.write_nifti(d / "totalseg.nii.gz", seg.astype(np.int16) if i == 2 else seg)
        entry = {"image": f"cases/{name}/image.nii.gz", "totalseg": f"cases/{name}/totalseg.nii.gz",
                 "text": f"report {i}", "text_features": f"cases/{name}/features.npz"}
        if i != 1:
            tnifti.write_nifti(d / "crcseg.nii.gz", tumor)
            entry["crcseg"] = f"cases/{name}/crcseg.nii.gz"
        np.savez(d / "features.npz", features=rng.standard_normal(feat).astype(np.float32))
        index[name] = entry
        tnifti.write_nifti(root / "nnunet" / "imagesTr" / f"{name}_0000.nii.gz", img)
        labels = tclasses.remap_totalseg_labels(seg, tumor if i != 1 else None)
        tnifti.write_nifti(root / "nnunet" / "labelsTr" / f"{name}.nii.gz", labels.astype(np.uint8))
    (root / "index.json").write_text(json.dumps(index))
    return {"index": str(root / "index.json"), "nnunet": str(root / "nnunet")}


# --- NIfTI -------------------------------------------------------------------

def _big_endian_copy(src, dst) -> None:
    """The uncompressed NIfTI `src` with every header field this codec reads
    and the voxels in big-endian order."""
    raw = bytearray(open(src, "rb").read())
    hdr = raw[:352]
    fields = [(0, "i"), (40, "8h"), (70, "h"), (72, "h"), (76, "8f"), (108, "f"), (112, "2f"), (252, "2h"),
              (280, "12f")]
    for off, fmt in fields:
        struct.pack_into(">" + fmt, hdr, off, *struct.unpack_from("<" + fmt, raw, off))
    dtype = tnifti._DTYPES[struct.unpack_from("<h", raw, 70)[0]]
    body = np.frombuffer(bytes(raw[352:]), dtype=np.dtype(dtype).newbyteorder("<")).astype(
        np.dtype(dtype).newbyteorder(">"))
    open(dst, "wb").write(bytes(hdr) + body.tobytes())


DTYPES = [np.uint8, np.int16, np.int32, np.float32, np.float64, np.int8, np.uint16, np.uint32, np.int64, np.uint64]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_read_nifti_matches_jax(tmp_path, writer, dtype):
    rng = np.random.default_rng(1)
    data = (rng.random((4, 5, 7)) * 100).astype(dtype)
    write = tnifti.write_nifti if writer == "port" else jnifti.write_nifti
    for name in ("v.nii.gz", "v.nii"):
        write(tmp_path / name, data, spacing=(0.7, 0.8, 2.5))
        got, ginfo = tnifti.read_nifti(tmp_path / name)
        want, winfo = jnifti.read_nifti(tmp_path / name)
        assert got.dtype == want.dtype == np.dtype(dtype) and got.flags.writeable
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(got, want)
        assert ginfo["spacing"] == winfo["spacing"] == pytest.approx((0.7, 0.8, 2.5))
        np.testing.assert_array_equal(ginfo["affine"], winfo["affine"])


@pytest.mark.parametrize("case", ["big_endian", "ni1", "scaled", "4d", "scaled_big_endian"])
def test_read_nifti_headers_match_jax(tmp_path, case):
    """Big-endian files come back in the machine's byte order (torch takes
    no other), with the JAX reader's values; `ni1`; scl_slope / scl_inter
    (float32 out); a 4D volume on reversed axes."""
    rng = np.random.default_rng(2)
    data = (rng.standard_normal((2, 3, 4, 5) if case == "4d" else (3, 4, 5)) * 50).astype(np.int16)
    path = tmp_path / "v.nii"
    tnifti.write_nifti(path, data)
    if case.startswith("scaled"):
        raw = bytearray(path.read_bytes())
        struct.pack_into("<2f", raw, 112, 2.5, -3.0)
        path.write_bytes(bytes(raw))
    if case == "ni1":
        raw = bytearray(path.read_bytes())
        raw[344:348] = b"ni1\x00"
        path.write_bytes(bytes(raw))
    if case.endswith("big_endian"):
        _big_endian_copy(path, tmp_path / "be.nii")
        path = tmp_path / "be.nii"
    got, ginfo = tnifti.read_nifti(path)
    want, winfo = jnifti.read_nifti(path)
    assert got.dtype.isnative and got.shape == want.shape == data.shape
    assert got.dtype == (np.float32 if case.startswith("scaled") else np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data * 2.5 - 3.0 if case.startswith("scaled") else data)
    assert ginfo["spacing"] == winfo["spacing"]


def test_read_nifti_rejects_what_it_cannot_read(tmp_path):
    path = tmp_path / "v.nii"
    tnifti.write_nifti(path, np.zeros((2, 2, 2), np.float32))
    raw = bytearray(path.read_bytes())
    bad = {"magic": raw[:344] + b"xx1\x00" + raw[348:], "short": raw[:100],
           "dtype": raw[:70] + struct.pack("<h", 32) + raw[72:], "size": struct.pack("<i", 999) + raw[4:]}
    for what, content in bad.items():
        (tmp_path / f"{what}.nii").write_bytes(bytes(content))
        with pytest.raises(ValueError):
            tnifti.read_nifti(tmp_path / f"{what}.nii")


# --- transforms --------------------------------------------------------------

RESIZES = [((12, 40, 40), (8, 16, 16)), ((12, 40, 40), (8, 40, 40)), ((7, 9, 11), (9, 30, 30)),
           ((9, 30, 30), (6, 13, 17)), ((96, 32, 32), (64, 8, 8))]


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("shapes", RESIZES, ids=lambda s: f"{s[0]}->{s[1]}")
@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_resize_volume_matches_jax_image_resize(method, shapes, channels):
    src, dst = shapes
    rng = np.random.default_rng(3)
    extra = () if channels is None else (channels,)
    if method == "nearest":
        for dtype in (np.int32, np.uint8):
            vol = rng.integers(0, 12, src + extra).astype(dtype)
            got = ttf.resize_volume(vol, dst, "nearest")
            want = np.asarray(jax.image.resize(vol, dst + extra, "nearest"))
            assert got.dtype == np.dtype(dtype) and got.shape == dst + extra
            np.testing.assert_array_equal(got, want)
        return
    vol = rng.random(src + extra).astype(np.float32)
    got = ttf.resize_volume(vol, dst, method)
    want = np.asarray(jtf.resize_volume(vol, dst, method))
    assert got.dtype == np.float32 and got.shape == want.shape == dst + extra
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("target", [(4, 8, 8), (6, 20, 24), (9, 25, 31), (3, 21, 17)])
def test_crop_or_pad_matches_jax(target):
    vol = np.random.default_rng(4).random((6, 20, 24, 2)).astype(np.float32)
    got, want = ttf.crop_or_pad(vol, target, 0.5), jtf.crop_or_pad(vol, target, 0.5)
    assert got.shape == target + (2,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_random_flip_and_one_hot_match_jax(seed):
    a = np.random.default_rng(5).random((3, 4, 5))
    b = np.arange(60).reshape(3, 4, 5)
    got = ttf.random_flip(np.random.default_rng(seed), a, b, axis=1)
    want = jtf.random_flip(np.random.default_rng(seed), a, b, axis=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    labels = np.random.default_rng(seed).integers(-2, 14, (3, 4))
    np.testing.assert_array_equal(ttf.one_hot_np(labels, 12), jtf.one_hot_np(labels, 12))
    assert tds.one_hot_np is ttf.one_hot_np  # the datasets module re-exports it


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32])
@pytest.mark.parametrize("with_tumor", [False, True])
def test_remap_totalseg_labels_matches_jax(dtype, with_tumor):
    rng = np.random.default_rng(6)
    seg = rng.choice(np.array(IDS + (0, 7, 200, 255), dtype), size=(5, 6, 7))
    tumor = (rng.random((5, 6, 7)) > 0.8).astype(np.uint8) if with_tumor else None
    got, want = tclasses.remap_totalseg_labels(seg, tumor), jclasses.remap_totalseg_labels(seg, tumor)
    assert got.dtype == np.int32 and set(np.unique(got)) <= set(range(12))
    np.testing.assert_array_equal(got, want)
    assert tclasses.TOTALSEG_DESIGNATED_LABELS == jclasses.TOTALSEG_DESIGNATED_LABELS


@pytest.mark.parametrize("n,frac,seed", [(1, 0.05, 0), (3, 0.05, 0), (20, 0.2, 3), (57, 0.05, 11)])
def test_train_val_split_matches_jax(n, frac, seed):
    keys = [f"k{i * 7 % n:03d}" for i in range(n)]
    assert tds.train_val_split(keys, frac, seed) == jds.train_val_split(keys, frac, seed)


PIPELINES = [["flip", "pad", "colorjitter", "torchvision_normalise"], ["randomcrop", "flip"],
             ["resize", "colorjitter"], ["randomscale", "randomcrop", "pad", "torchvision_normalise"]]


@pytest.mark.parametrize("names", PIPELINES, ids=lambda n: "+".join(n))
def test_build_transforms_matches_jax(names):
    """Labels and unresampled images equal; resampled images within 1e-5."""
    rng = np.random.default_rng(7)
    settings = {"target_size": (24, 20), "scale_range": (0.7, 1.3)}
    for seed in range(3):
        item = {"image": rng.random((22, 18, 1)).astype(np.float32), "label": rng.integers(0, 4, (22, 18)),
                "casename": "x"}
        got = tpipe.build_transforms(names, settings)(dict(item), np.random.default_rng(seed))
        want = jpipe.build_transforms(names, settings)(dict(item), np.random.default_rng(seed))
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["label"], np.asarray(want["label"]))
        resampled = "resize" in names or "randomscale" in names
        np.testing.assert_allclose(got["image"], np.asarray(want["image"]), rtol=0, atol=1e-5 if resampled else 0)


# --- datasets ----------------------------------------------------------------

def _assert_items_equal(got: dict, want: dict, close=()):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            if k in close:
                np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def _dataset_pairs(fx):
    index = fx["index"]
    return {
        "ruijin": (lambda m, s: m.RuijinMaskDataset(index, split=s, volume_shape=(4, 8, 10)), ()),
        "ruijin_max_size": (lambda m, s: m.RuijinMaskDataset(index, split=s, volume_shape=(3, 25, 12), max_size=2,
                                                             seed=4), ()),
        "ruijin_slices": (lambda m, s: m.RuijinSlicePairDataset(index, split=s, slice_shape=(16, 28)), ()),
        "ruijin_3d": (lambda m, s: m.RuijinVolumeDataset(index, split=s, volume_shape=(4, 8, 10)), ("image",)),
        "nnunet": (lambda m, s: m.NNUNetLayoutDataset(fx["nnunet"], split=s, slice_shape=(22, 20), seed=2), ()),
    }


@pytest.mark.parametrize("kind", ["ruijin", "ruijin_max_size", "ruijin_slices", "ruijin_3d", "nnunet"])
def test_dataset_items_match_jax(tmp_path, jax_pure, kind):
    fx = write_cases(tmp_path)
    make, close = _dataset_pairs(fx)[kind]
    for split in ("train", "val"):
        got_ds, want_ds = make(tds, split), make(jds, split)
        assert len(got_ds) == len(want_ds) > 0 and got_ds.keys == want_ds.keys
        for epoch in (0, 1):
            for ds in (got_ds, want_ds):
                if hasattr(ds, "set_epoch"):
                    ds.set_epoch(epoch)
            for i in range(len(got_ds)):
                _assert_items_equal(got_ds[i], want_ds[i], close)


def test_dataset_contents(tmp_path):
    """What the items hold: one-hot masks of remapped labels, the context,
    the [prev, mask] condition with zeros at z = 0, the volumes outside
    training, and epoch-varying draws."""
    fx = write_cases(tmp_path)
    ds = tds.RuijinMaskDataset(fx["index"], volume_shape=(6, 20, 24), augment=False)
    item = ds[0]
    case = ds.index[ds.keys[0]]
    seg, _ = tnifti.read_nifti(ds._resolve(case["totalseg"]))
    tumor, _ = tnifti.read_nifti(ds._resolve(case["crcseg"]))
    np.testing.assert_array_equal(np.argmax(item["mask"], -1), tclasses.remap_totalseg_labels(seg, tumor))
    assert item["context"].shape == (5, 16) and item["text"] == "report 0" and not item["image"].any()
    pairs = tds.RuijinSlicePairDataset(fx["index"], slice_shape=CASE_SHAPE[1:])
    zs = set()
    for epoch in range(6):
        pairs.set_epoch(epoch)
        it = pairs[0]
        img, _ = tnifti.read_nifti(pairs._resolve(pairs.index[pairs.keys[0]]["image"]))
        z = int(np.flatnonzero([np.array_equal(it["image"][..., 0], s) for s in ttf.window_norm(img)])[0])
        zs.add(z)
        want_prev = ttf.window_norm(img)[z - 1] if z else np.zeros(CASE_SHAPE[1:], np.float32)
        np.testing.assert_array_equal(it["cond"][..., 0], want_prev)
        assert "wholeimage" not in it
    assert len(zs) > 1
    val = tds.RuijinSlicePairDataset(fx["index"], split="val", slice_shape=(8, 8))[0]
    assert val["wholeimage"].shape == (6, 8, 8, 1) and val["wholemask"].max() <= 1.0


def test_slice_cache_h5(tmp_path, monkeypatch):
    """`cache_h5` keeps the decoded volumes (the second read comes from the
    file) and needs h5py only then; without h5py it names the package."""
    fx = write_cases(tmp_path)
    plain = tds.RuijinSlicePairDataset(fx["index"], split="val", slice_shape=(16, 28))[0]
    cached = tds.RuijinSlicePairDataset(fx["index"], split="val", slice_shape=(16, 28),
                                        cache_h5=str(tmp_path / "cache.h5"))
    for _ in range(2):
        _assert_items_equal(cached[0], plain)
    assert (tmp_path / "cache.h5").exists()
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    nocache = tds.RuijinSlicePairDataset(fx["index"], split="val", slice_shape=(16, 28),
                                         cache_h5=str(tmp_path / "other.h5"))
    with pytest.raises(ImportError, match="h5py"):
        nocache[0]
    _assert_items_equal(tds.RuijinSlicePairDataset(fx["index"], split="val", slice_shape=(16, 28))[0], plain)


def test_loader_first_batch_matches_jax(tmp_path, jax_pure):
    fx = write_cases(tmp_path)
    for kind in ("ruijin", "ruijin_slices"):
        make, _ = _dataset_pairs(fx)[kind]
        got = next(iter(TLoader(make(tds, "train"), 2, seed=3, device="cpu")))
        want = next(iter(JLoader(make(jds, "train"), 2, seed=3, num_workers=1)))
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, list):
                assert got[k] == w
            else:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
