"""PyTorch port: `cli.build_index` against the JAX package's, on the CPU.

Both CLIs on one tree write the same JSON (cases with and without a
tumour mask or a report, a directory without a TotalSegmentator volume
skipped, paths relative to the index's directory, or absolute outside it).
With `--bert` on a tiny local BERT (`transformers` installed, else skipped)
the `features` arrays agree within 1e-5 absolute, and the index names the
same files.  The index feeds the Ruijin datasets.
"""

import json

import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import build_index as tindex
from jointimagegeneration_torch.cli.common import build_mask_dataset
from jointimagegeneration_torch.data.nifti import write_nifti
from jointimagegeneration_tpu.cli import build_index as jindex

from test_torch_text import _tiny_bert


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root):
    """Four case directories: a, b (no crcseg), c (no report), and d without
    a TotalSegmentator volume; a report for a, b and an absent case."""
    rng = np.random.default_rng(0)
    for name, files in (("a", ("ct_image", "x_totalseg", "x_crcseg")), ("b", ("image", "totalseg")),
                        ("c", ("image", "totalseg", "crcseg")), ("d", ("image",))):
        (root / name).mkdir(parents=True)
        for f in files:
            write_nifti(root / name / f"{f}.nii.gz", rng.integers(0, 3, (3, 4, 5)).astype(np.uint8))
    texts = root.parent / "texts.json"
    texts.write_text(json.dumps({"a": "the liver is enlarged", "b": "no mass", "z": "normal spleen"}))
    return texts


@pytest.mark.parametrize("where", ["beside", "above", "elsewhere"])
def test_build_index_matches_jax(tmp_path, where):
    """The index beside the tree, above it, or where the tree is not under
    its directory (absolute paths)."""
    root = tmp_path / "data" / "tree"
    texts = _tree(root)
    out_dir = {"beside": root, "above": tmp_path, "elsewhere": tmp_path / "indexes" / "x"}[where]
    out_dir.mkdir(parents=True, exist_ok=True)
    args = [str(root), None, "--texts", str(texts)]
    jindex.main([args[0], str(out_dir / "jax.json")] + args[2:])
    got = tindex.main([args[0], str(out_dir / "port.json")] + args[2:])
    assert (out_dir / "port.json").read_text() == (out_dir / "jax.json").read_text()
    assert json.loads((out_dir / "port.json").read_text()) == got
    assert sorted(got) == ["a", "b", "c"] and "crcseg" not in got["b"] and "text" not in got["c"]
    assert got["a"]["text"] == "the liver is enlarged"
    assert all(v.startswith("/") == (where == "elsewhere") for e in got.values() for k, v in e.items() if k != "text")


def test_build_index_with_bert_matches_jax(tmp_path):
    bert = _tiny_bert(tmp_path)
    root = tmp_path / "tree"
    texts = _tree(root)
    jindex.main([str(root), str(tmp_path / "jax.json"), "--texts", str(texts), "--bert", bert])
    want = {n: np.load(root / "text_features" / f"{n}.npz")["features"] for n in ("a", "b")}
    got_index = tindex.main([str(root), str(tmp_path / "port.json"), "--texts", str(texts), "--bert", bert,
                             "--device", "cpu"])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert got_index["a"]["text_features"] == "tree/text_features/a.npz" and "text_features" not in got_index["c"]
    for name, w in want.items():
        with np.load(root / "text_features" / f"{name}.npz") as z:
            assert z.files == ["features"]
            g = z["features"]
        assert g.dtype == np.float32 and g.shape == w.shape and g.shape[-1] == 16
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # the index feeds the stage-1 dataset: each case's context is its features
    ds = build_mask_dataset({"dataset": {"kind": "ruijin", "index": str(tmp_path / "port.json"),
                                         "volume_shape": [2, 2, 2]}}, "train")
    for i in range(len(ds)):
        item = ds[i]
        if item["casename"] in want:
            np.testing.assert_array_equal(item["context"], np.load(root / "text_features" /
                                                                   f"{item['casename']}.npz")["features"])


def test_build_index_bert_without_device_needs_cuda(tmp_path):
    """The BERT features run on the card unless `--device cpu` is given."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    bert = _tiny_bert(tmp_path)
    root = tmp_path / "tree"
    texts = _tree(root)
    with pytest.raises(RuntimeError, match="CUDA"):
        tindex.main([str(root), str(tmp_path / "i.json"), "--texts", str(texts), "--bert", bert])
