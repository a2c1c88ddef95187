"""PyTorch port: FVD (the Frechet distance, the pyramid features, the I3D
backbone and its converter) against the JAX package on the CPU, and FVD in
`cli.sample`'s `stage: ct`.

The I3D runs from a seeded state dict in the standard `<Unit>.conv3d.weight`
/ `<Unit>.bn.*` naming (`tests/test_i3d_golden.py::_random_sd`) at (1, 9, 32,
32, 3) and at odd sizes, where TF 'SAME' pads one more after than before; its
400 features within 1e-4 of their max |JAX value|.  The JAX I3D is jitted
here: one compile per size takes ~2-4 s, its eager op-by-op dispatch ~15-19
s.  The Frechet distance within 1e-6 relative, on full-rank features and on
two samples (scipy's sqrtm fails there; both take the eigh route)."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import convert_i3d
from jointimagegeneration_torch.cli import sample as tcli
from jointimagegeneration_torch.cli.common import build_slice_dataset
from jointimagegeneration_torch.eval import fvd as tfvd
from jointimagegeneration_torch.eval import i3d as ti3d
from jointimagegeneration_torch.eval import metrics as tmetrics
from jointimagegeneration_tpu.eval import fvd as jfvd
from jointimagegeneration_tpu.eval import i3d as ji3d
from jointimagegeneration_tpu.eval import metrics as jmetrics

from test_i3d_golden import _random_sd
from test_torch_sample_ct import _ct_cfg

ROOT = Path(__file__).resolve().parents[1]
I3D_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def i3d_sd():
    return _random_sd(0)


@pytest.mark.parametrize("n,d", [(40, 6), (2, 6), (3, 5)])
def test_frechet_distance_matches_jax(n, d):
    rs = np.random.RandomState(n)
    a = rs.randn(n, d)
    b = 0.7 * rs.randn(n, d) + 0.3
    want = jmetrics.frechet_distance(a, b)
    got = tmetrics.frechet_distance(a, b)
    assert np.isfinite(want) and abs(got - want) <= 1e-6 * abs(want)
    assert abs(tmetrics.frechet_distance(a, a)) <= 1e-6 * abs(want)


def test_trace_sqrt_product_falls_back_on_two_samples():
    """Two samples give rank-1 covariances: scipy's sqrtm gives non-finite
    values or raises, and the eigh route answers in both packages."""
    rs = np.random.RandomState(0)
    sa, sb = np.cov(rs.randn(2, 5), rowvar=False), np.cov(rs.randn(2, 5), rowvar=False)
    want = jmetrics._trace_sqrt_product(sa, sb, 1e-6)
    assert np.isfinite(want)
    assert abs(tmetrics._trace_sqrt_product(sa, sb, 1e-6) - want) <= 1e-6 * max(abs(want), 1e-12)


def test_dice_precision_recall_match_jax():
    rs = np.random.RandomState(1)
    pred, target = rs.randint(0, 4, (6, 7, 5)), rs.randint(0, 4, (6, 7, 5))
    cm = jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(target), 4)
    for ignore in (None, 0):
        np.testing.assert_allclose(tmetrics.dice_from_confusion(torch.from_numpy(np.asarray(cm)), ignore).numpy(),
                                   np.asarray(jmetrics.dice_from_confusion(cm, ignore)), rtol=1e-6)
    for got, want in zip(tmetrics.per_class_precision_recall(torch.from_numpy(pred), torch.from_numpy(target), 4),
                         jmetrics.per_class_precision_recall(jnp.asarray(pred), jnp.asarray(target), 4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7, 9, 11), (3, 16, 16), (1, 5, 4)])
def test_downsample_features_match_jax(shape):
    vol = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    got, want = tfvd.downsample_feature_fn(vol), jfvd.downsample_feature_fn(vol)
    assert got.shape == want.shape == (78,) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 9, 32, 32, 3), (2, 7, 21, 19, 3)])
def test_i3d_matches_jax(i3d_sd, shape):
    units = ji3d.parse_torch_i3d_sd(i3d_sd)
    ported = ti3d.parse_torch_i3d_sd(i3d_sd)
    assert units.keys() == ported.keys()
    for u in units:
        for leaf in ("kernel", "scale", "bias"):
            np.testing.assert_array_equal(ported[u][leaf], units[u][leaf])
    video = np.random.RandomState(shape[1]).uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jax.jit(ji3d.i3d_features)({u: {k: jnp.asarray(v) for k, v in d.items()}
                                                  for u, d in units.items()}, jnp.asarray(video)))
    params = {u: {k: torch.from_numpy(v) for k, v in d.items()} for u, d in ported.items()}
    with torch.no_grad():
        got = ti3d.i3d_features(params, torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (shape[0], 400)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= I3D_TOL, err


def test_same_pad_is_asymmetric():
    """ceil(n / s) outputs; the extra pad after: n = 8, k = 7, s = 2 pads
    (2, 3); a stride-1 pool of 3 pads (1, 1); n = 5, k = 3, s = 2 pads (1, 1)."""
    x = torch.zeros(1, 1, 8, 5, 4)
    assert ti3d._same_pad(x, (7, 3, 1), (2, 2, 1), 0.0).shape == (1, 1, 8 + 5, 5 + 2, 4)
    y = ti3d._maxpool(torch.arange(5.0).view(1, 1, 1, 1, 5), (1, 1, 3), (1, 1, 2))
    assert y.flatten().tolist() == [1.0, 3.0, 4.0]  # -inf pads, never read as 0


def _run_jax_converter(src, out):
    spec = importlib.util.spec_from_file_location("convert_i3d_weights", ROOT / "scripts" / "convert_i3d_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = sys.argv
    sys.argv = ["convert_i3d_weights.py", "--i3d", str(src), "--out", str(out)]
    try:
        mod.main()
    finally:
        sys.argv = argv


def test_converter_matches_the_jax_script(i3d_sd, tmp_path, capsys):
    """The same `.npz` arrays from the same state dict; each file loads in
    the other package; a torchscript archive converts too."""
    torch.save(i3d_sd, tmp_path / "i3d.pt")
    convert_i3d.main(["--i3d", str(tmp_path / "i3d.pt"), "--out", str(tmp_path / "port.npz")])
    assert "converted 58 I3D units" in capsys.readouterr().out
    _run_jax_converter(tmp_path / "i3d.pt", tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 58 * 3
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    in_jax = ji3d.load_i3d_npz(tmp_path / "port.npz")
    in_port = ti3d.load_i3d_npz(tmp_path / "jax.npz")
    assert in_jax.keys() == in_port.keys()
    for u in in_jax:
        for leaf, v in in_jax[u].items():
            np.testing.assert_array_equal(in_port[u][leaf].numpy(), np.asarray(v))

    class Units(torch.nn.Module):  # a torchscript archive with two units' tensors
        def __init__(self):
            super().__init__()
            self.logits = torch.nn.Module()
            self.logits.conv3d = torch.nn.Conv3d(1024, 400, 1)
            self.Conv3d_1a_7x7 = torch.nn.Module()
            self.Conv3d_1a_7x7.conv3d = torch.nn.Conv3d(3, 64, 7, bias=False)
            self.Conv3d_1a_7x7.bn = torch.nn.BatchNorm3d(64, eps=1e-3)

        def forward(self, x):
            return x

    scripted = torch.jit.script(Units())
    scripted.save(str(tmp_path / "scripted.pt"))
    assert convert_i3d.convert(tmp_path / "scripted.pt", tmp_path / "s.npz") == 2
    with np.load(tmp_path / "s.npz") as z:
        np.testing.assert_array_equal(z["logits/kernel"], np.transpose(
            scripted.logits.conv3d.weight.detach().numpy(), (2, 3, 4, 1, 0)))
    torch.save({"unrelated": torch.zeros(2)}, tmp_path / "bad.pt")
    with pytest.raises(SystemExit, match="unrecognised"):
        convert_i3d.convert(tmp_path / "bad.pt", tmp_path / "bad.npz")


@pytest.mark.parametrize("i3d", [False, True], ids=["pyramid", "i3d"])
def test_ct_stage_writes_fvd(tmp_path, i3d_sd, i3d):
    """Two `stage: ct` cases with metrics: metrics.json holds the JAX CLI's
    keys, the FVD that `eval.fvd.fvd` gives over the dataset's volumes and
    the generated ones (the pyramid's equal to the JAX package's), and the
    extractor's name."""
    extra = {}
    if i3d:
        torch.save(i3d_sd, tmp_path / "i3d.pt")
        convert_i3d.convert(tmp_path / "i3d.pt", tmp_path / "i3d.npz")
        extra["i3d_weights"] = str(tmp_path / "i3d.npz")
    cfg = _ct_cfg(tmp_path, False, n_cases=2, **extra)
    out = tcli.run(cfg)
    metrics = json.loads((tmp_path / "out" / "metrics.json").read_text())
    assert metrics == out["metrics"]
    assert set(metrics) == {"lpips_three_view_mean", "lpips_per_case", "fvd", "fvd_feature_extractor",
                            "fvd_backbone"}
    name = "i3d" if i3d else "pyramid-uncalibrated"
    assert metrics["fvd_feature_extractor"] == metrics["fvd_backbone"] == name
    ds = build_slice_dataset(cfg["stage2"], "val")
    gt = [ds[i]["wholeimage"][..., 0] for i in range(2)]
    gen = list(out["ct"])
    feat = tfvd.i3d_npz_feature_fn(extra["i3d_weights"], "cpu") if i3d else None
    want = tfvd.fvd(gt, gen, feat)
    assert np.isfinite(metrics["fvd"]) and metrics["fvd"] == pytest.approx(want, rel=1e-6)
    if not i3d:
        assert metrics["fvd"] == pytest.approx(jfvd.fvd(gt, gen), rel=1e-6)


def test_npz_feature_fn_matches_jax(i3d_sd, tmp_path):
    """A (D, H, W) volume in [0, 1] -> (400,) through both packages'
    `i3d_npz_feature_fn` on one converted file."""
    torch.save(i3d_sd, tmp_path / "i3d.pt")
    convert_i3d.convert(tmp_path / "i3d.pt", tmp_path / "i3d.npz")
    vol = np.random.RandomState(2).rand(5, 16, 16).astype(np.float32)
    got = tfvd.i3d_npz_feature_fn(str(tmp_path / "i3d.npz"), "cpu")(vol)
    want = jfvd.i3d_npz_feature_fn(str(tmp_path / "i3d.npz"))(vol)
    assert got.shape == want.shape == (400,)
    assert np.abs(got - want).max() <= I3D_TOL * np.abs(want).max()
