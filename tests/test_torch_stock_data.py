"""PyTorch port: the stock and generic datasets against the JAX package.

Over trees written in `tmp_path` (RGB PNG / JPEG files of several sizes, a
synset tree with the reference's ignored file and a `synset_human.txt`, an
LSUN filelist, an HDF5 file, `.npy` / `.npz` / NIfTI arrays), every item of
the port's `LSUNBase`, `lsun_dataset`, `ImageNetLocal` (filelist, synset
filter), `SRDataset` (bsrgan_light, light, cv_bicubic, pil_bicubic),
`SRToLDMAdapter`, `H5Dataset`, `FileListDataset`, `TransformedPairDataset`
and `ImageFolderDataset` equals the JAX class's item key for key, bit for
bit, over two epochs; `ImageFolderDataset`'s resize, which the JAX class
takes from `jax.image.resize` and the port from `data/transforms.
resize_volume`, within 1e-5.  Then `cli.common.build_slice_dataset`'s three
stock kinds against the JAX CLI's, and the ImportError naming cv2, PIL or
h5py at construction when the package is hidden."""

import sys

import numpy as np
import pytest

from jointimagegeneration_torch.cli.common import build_slice_dataset as tbuild
from jointimagegeneration_torch.data import generic as tgen
from jointimagegeneration_torch.data import stock as tstock
from jointimagegeneration_tpu.cli.common import build_slice_dataset as jbuild
from jointimagegeneration_tpu.data import generic as jgen
from jointimagegeneration_tpu.data import stock as jstock


def _write_image(path, h, w, seed, mode="RGB"):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, 3) if mode == "RGB" else (h, w), np.uint8)
    Image.fromarray(arr, mode).save(str(path))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("stock")
    inet = root / "inet"
    sizes = [(70, 90), (64, 48), (81, 77)]
    for s, syn in enumerate(("n01440764", "n01443537", "n02102040")):
        for j in range(2):
            h, w = sizes[(s + j) % 3]
            _write_image(inet / syn / f"{syn}_{j}.JPEG", h, w, seed=10 * s + j, mode="L" if (s, j) == (1, 1) else "RGB")
    _write_image(inet / "n06596364" / "n06596364_9591.JPEG", 40, 40, seed=99)  # the reference's ignored file
    (inet / "synset_human.txt").write_text("n01440764 tench, Tinca tinca\nn01443537 goldfish\n")
    (root / "filelist.txt").write_text("n02102040/n02102040_1.JPEG\nn01440764/n01440764_0.JPEG\n"
                                       "n06596364/n06596364_9591.JPEG\n")
    lsun = root / "lsun"
    for i in range(3):
        _write_image(lsun / f"img_{i}.png", 40 + 3 * i, 33, seed=20 + i)
    (root / "lsun.txt").write_text("\n".join(f"img_{i}.png" for i in range(3)) + "\n")
    return root


def _assert_items_equal(jds, tds, epochs=(0, 1), atol=None):
    assert len(jds) == len(tds) > 0
    for epoch in epochs:
        for ds in (jds, tds):
            if hasattr(ds, "set_epoch"):
                ds.set_epoch(epoch)
        for i in range(len(jds)):
            want, got = jds[i], tds[i]
            assert sorted(want) == sorted(got), (sorted(want), sorted(got))
            for k, w in want.items():
                g = got[k]
                if isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
                    if atol is not None and k == "image":
                        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)
                    else:
                        np.testing.assert_array_equal(g, w, err_msg=k)
                else:
                    assert g == w, (k, g, w)


def test_lsun(trees):
    txt, root = str(trees / "lsun.txt"), str(trees / "lsun")
    for kw in ({"size": 16, "flip_p": 0.5}, {"size": None, "flip_p": 0.0}, {"size": 24, "interpolation": "bilinear"}):
        _assert_items_equal(jstock.LSUNBase(txt, root, seed=3, **kw), tstock.LSUNBase(txt, root, seed=3, **kw))
    for mod in (jstock, tstock):
        with pytest.raises(ValueError, match="unknown LSUN split"):
            mod.lsun_dataset("churches", "test")
    for split in ("train", "val"):
        jds = jstock.lsun_dataset("cats", split, txt_file=txt, data_root=root, size=16)
        tds = tstock.lsun_dataset("cats", split, txt_file=txt, data_root=root, size=16)
        assert tds.flip_p == jds.flip_p == (0.5 if split == "train" else 0.0)
        _assert_items_equal(jds, tds)


def test_imagenet_local(trees):
    root = str(trees / "inet")
    for kw in ({"size": 16}, {"size": 20, "random_crop": True, "flip_p": 0.5, "seed": 4},
               {"filelist": str(trees / "filelist.txt"), "size": 12},
               {"synsets": ["n01443537", "n02102040"], "size": 16, "random_crop": True},
               {"process_images": False}):
        jds, tds = jstock.ImageNetLocal(root, **kw), tstock.ImageNetLocal(root, **kw)
        _assert_items_equal(jds, tds)
    tds = tstock.ImageNetLocal(root, size=16)
    assert len(tds) == 6 and tds[0]["human_label"] == "tench, Tinca tinca" and tds[5]["human_label"] == "n02102040"
    assert [tds[i]["class_label"] for i in range(6)] == [0, 0, 1, 1, 2, 2]


@pytest.mark.parametrize("degradation", ["bsrgan_light", "light", "cv_bicubic", "pil_bicubic"])
def test_sr_dataset_and_adapter(trees, degradation):
    root = str(trees / "inet")
    for random_crop in (True, False):
        kw = dict(size=32, degradation=degradation, downscale_f=4, min_crop_f=0.5, max_crop_f=1.0,
                  random_crop=random_crop, seed=2)
        jsr = jstock.SRDataset(jstock.ImageNetLocal(root, process_images=False), **kw)
        tsr = tstock.SRDataset(tstock.ImageNetLocal(root, process_images=False), **kw)
        _assert_items_equal(jsr, tsr)
        jad, tad = jstock.SRToLDMAdapter(jsr), tstock.SRToLDMAdapter(tsr)
        _assert_items_equal(jad, tad)
        item = tad[0]
        assert set(item) == {"image", "cond"} and item["image"].shape == item["cond"].shape == (32, 32, 3)


def _write_h5(path):
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("case_a")
        g["image"] = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        g["label"] = np.arange(24, dtype=np.int64).reshape(2, 3, 4) % 3
        f["case_b"] = np.ones((2, 2), np.int16)


def test_generic_datasets(trees, tmp_path):
    from jointimagegeneration_torch.data.nifti import write_nifti

    h5 = tmp_path / "cases.h5"
    _write_h5(h5)
    _assert_items_equal(jgen.H5Dataset(str(h5)), tgen.H5Dataset(str(h5)))
    _assert_items_equal(jgen.H5Dataset(str(h5), keys=["case_b"]), tgen.H5Dataset(str(h5), keys=["case_b"]))
    rs = np.random.RandomState(0)
    np.save(tmp_path / "a.npy", rs.rand(3, 4).astype(np.float32))
    np.savez(tmp_path / "b.npz", first=rs.rand(2, 5), second=np.zeros(1))
    write_nifti(tmp_path / "c.nii.gz", rs.randint(0, 9, (3, 4, 5)).astype(np.int16))
    arrays = [str(tmp_path / n) for n in ("a.npy", "b.npz", "c.nii.gz")]
    pngs = str(trees / "lsun" / "*.png")
    (tmp_path / "list.txt").write_text("\n".join(arrays) + "\n")
    for files in (arrays, str(tmp_path / "list.txt"), pngs):
        _assert_items_equal(jgen.FileListDataset(files), tgen.FileListDataset(files))

    def transform(item):
        return {**item, "image": item["image"][::-1].copy()}

    jpair = jgen.TransformedPairDataset(jgen.H5Dataset(str(h5), keys=["case_a"]), transform, num_classes=3)
    tpair = tgen.TransformedPairDataset(tgen.H5Dataset(str(h5), keys=["case_a"]), transform, num_classes=3)
    _assert_items_equal(jpair, tpair)
    assert "mask" in tpair[0] and "label" not in tpair[0]
    inet = str(trees / "inet")
    # no resize, with the SR degradation: bit for bit
    _assert_items_equal(jgen.ImageFolderDataset(inet, sr_factor=4, seed=1),
                        tgen.ImageFolderDataset(inet, sr_factor=4, seed=1))
    # the linear (antialiased) resize: jax.image.resize against resize_volume
    _assert_items_equal(jgen.ImageFolderDataset(inet, size=24), tgen.ImageFolderDataset(inet, size=24), atol=1e-5)
    _assert_items_equal(jgen.ImageFolderDataset(inet, size=96), tgen.ImageFolderDataset(inet, size=96), atol=1e-5)


def test_build_slice_dataset_stock_kinds(trees):
    lsun = {"kind": "lsun", "txt_file": str(trees / "lsun.txt"), "data_root": str(trees / "lsun")}
    inet = {"kind": "imagenet", "root": str(trees / "inet"), "synsets": ["n01440764", "n02102040"]}
    sr = {"kind": "imagenet_sr", "root": str(trees / "inet"), "size": 32, "degradation": "bsrgan_light"}
    for d in (lsun, {**lsun, "size": 20, "flip_p": 1.0}, inet, {**inet, "filelist": str(trees / "filelist.txt")}, sr,
              {**sr, "degradation": "cv_bicubic", "min_crop_f": 0.8}):
        for split in ("train", "val"):
            cfg = {"dataset": {**d, "slice_shape": [16, 16]}}
            _assert_items_equal(jbuild(cfg, split), tbuild(cfg, split), epochs=(0,))
    assert tbuild({"dataset": {**lsun, "slice_shape": [16, 16]}}, "train")[0]["image"].shape == (16, 16, 3)


@pytest.mark.parametrize("hidden,build", [
    ("PIL", lambda t: tstock.LSUNBase(str(t / "lsun.txt"), str(t / "lsun"))),
    ("PIL", lambda t: tstock.ImageNetLocal(str(t / "inet"))),
    ("cv2", lambda t: tstock.SRDataset(tstock.ImageNetLocal(str(t / "inet"), process_images=False), size=32)),
    ("scipy", lambda t: tstock.SRDataset(tstock.ImageNetLocal(str(t / "inet"), process_images=False), size=32)),
    ("cv2", lambda t: tbuild({"dataset": {"kind": "imagenet_sr", "root": str(t / "inet")}}, "train")),
    ("PIL", lambda t: tbuild({"dataset": {"kind": "imagenet_sr", "root": str(t / "inet")}}, "train")),
    ("h5py", lambda t: tgen.H5Dataset(str(t / "missing.h5"))),
    ("PIL", lambda t: tgen.ImageFolderDataset(str(t / "inet"))),
    ("PIL", lambda t: tgen.FileListDataset(str(t / "lsun" / "*.png"))),
], ids=["lsun-PIL", "imagenet-PIL", "sr-cv2", "sr-scipy", "kind-cv2", "kind-PIL", "h5", "folder-PIL", "filelist-PIL"])
def test_missing_package_raises_at_construction(trees, monkeypatch, hidden, build):
    monkeypatch.setitem(sys.modules, hidden, None)
    with pytest.raises(ImportError, match=f"needs the .*{hidden}"):
        build(trees)


def test_without_the_packages_arrays_and_labels_still_load(trees, monkeypatch, tmp_path):
    for m in ("PIL", "cv2"):
        monkeypatch.setitem(sys.modules, m, None)
    np.save(tmp_path / "a.npy", np.zeros(3, np.float32))
    assert tgen.FileListDataset([str(tmp_path / "a.npy")])[0]["image"].shape == (3,)
    assert tstock.ImageNetLocal(str(trees / "inet"), process_images=False)[0]["class_label"] == 0
    with pytest.raises(ValueError, match="unknown degradation"):  # a bad name before the packages
        tstock.SRDataset(tstock.ImageNetLocal(str(trees / "inet"), process_images=False), size=32,
                         degradation="bsrgan_heavy")
