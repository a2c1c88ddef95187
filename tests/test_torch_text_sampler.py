"""PyTorch port: text-guided stage-1 sampling against the JAX package, on the
CPU: the MaskSampler with a refiner and a cross-attention UNet, label
guidance, `stage: mask` and the text `two_stage` through the CLI, and the
distribution metrics.

The JAX random draws are replayed through the port's noise interface.
Labels must be equal: the JAX sampler refines the context inside every step,
the port once per `sample` call, and nothing in the refinement is random at
sampling.  GED and HM-IoU within 1e-12 (the same float64 arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import sample as tcli
from jointimagegeneration_torch.cli.common import build_mask_dataset
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.eval import metrics as tmetrics
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.pipeline.two_stage import make_chunked_two_stage_programs
from jointimagegeneration_torch.utils.jax_weights import flatten_tree
from jointimagegeneration_tpu.data.nifti import read_nifti
from jointimagegeneration_tpu.eval import metrics as jmetrics
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler

from test_torch_weights import ReplayNoise, init_flax, jax_mask_draws, to_numpy, to_torch

KW = dict(num_classes=4, time_steps=20, model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,),
          num_res_blocks=1, num_head_channels=4)
REFINER = {"type": "selfattn", "embed_dim": 24, "n_heads": 2, "d_head": 8, "model_depth": 2, "dropout": 0.2}
SHAPE, CTX_LEN = (1, 4, 8, 8), 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def guidance(p):
    """A label-reference gradient stand-in that works on jnp and torch arrays."""
    return 0.4 * p * p


def _save(tree, path):
    np.savez(path, **{"/".join(k): v for k, v in flatten_tree(tree).items()})
    return str(path)


@pytest.fixture(scope="module")
def text_models(tmp_path_factory):
    """(JAX sampler with a refiner, its {"unet", "refiner"} tree, the port's
    sampler loaded from that tree's .npz, the .npz path, a raw context)."""
    jm = MaskSampler.create(context_dim=24, text_refiner=REFINER, **KW)
    rs = np.random.RandomState(4)
    ctx = rs.randn(1, CTX_LEN, 24).astype(np.float32)
    pu = init_flax(jm.unet, jnp.zeros((*SHAPE, 4)), jnp.zeros((1,)), cond=jnp.zeros((*SHAPE, 1)),
                   context=jnp.asarray(ctx))
    pr = init_flax(jm.refiner, jnp.asarray(ctx), seed=3)
    tree = {"unet": {"params": pu}, "refiner": {"params": pr}}
    path = _save(tree, tmp_path_factory.mktemp("ck") / "stage1.npz")
    tm = TMask.create(cond_channels=1, device="cpu", context_dim=24, text_refiner=REFINER, **KW)
    tcli.load_mask_weights(tm, path, 0.0, 0)
    return jm, jax.tree.map(jnp.asarray, tree), tm, path, ctx


def test_refined_context_matches_jax(text_models):
    jm, p, tm, _, ctx = text_models
    want = np.asarray(jm.refine_context(p, jnp.asarray(ctx)))
    with torch.no_grad():
        got = to_numpy(tm.refine_context(to_torch(ctx)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert tm.refine_context(None) is None


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("t", [1, 9])
def test_denoise_step_with_context_matches_jax(text_models, guided, t):
    """One step from a random one-hot x_t: the draw at t > 1, the decode at
    t = 1; guidance subtracts from the posterior before the clamp."""
    jm, p, tm, _, ctx = text_models
    rs = np.random.RandomState(t)
    xt = np.eye(4, dtype=np.float32)[rs.randint(0, 4, SHAPE)]
    cond = rs.rand(*SHAPE, 1).astype(np.float32)
    key = jax.random.key(t)
    gfn = guidance if guided else None
    want = np.asarray(jm.denoise_step(p, key, jnp.asarray(xt), jnp.full((1,), t, jnp.int32), cond=jnp.asarray(cond),
                                      context=jnp.asarray(ctx), guidance_fn=gfn))
    noise = ReplayNoise([("gumbel", np.asarray(jax.random.gumbel(key, xt.shape, jnp.float32)))])
    got = tm.denoise_step(noise, to_torch(xt), torch.full((1,), t), cond=to_torch(cond), context=to_torch(ctx),
                          guidance_fn=gfn).numpy()
    assert not noise.draws
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("guided", [False, True])
def test_sample_labels_with_context_equal_jax(text_models, guided):
    jm, p, tm, _, ctx = text_models
    cond = np.random.RandomState(2).rand(*SHAPE, 1).astype(np.float32)
    key = jax.random.key(17)
    gfn = guidance if guided else None
    want = np.asarray(jm.sample_labels(p, key, SHAPE, cond=jnp.asarray(cond), context=jnp.asarray(ctx),
                                       num_steps=4, guidance_fn=gfn))
    noise = ReplayNoise(jax_mask_draws(key, SHAPE, 4, 4))
    got = tm.sample_labels(noise, SHAPE, cond=to_torch(cond), context=to_torch(ctx), num_steps=4,
                           guidance_fn=gfn).numpy()
    assert not noise.draws and len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)
    # the context steers the labels: another context gives others
    other = tm.sample_labels(ReplayNoise(jax_mask_draws(key, SHAPE, 4, 4)), SHAPE, cond=to_torch(cond),
                             context=to_torch(-3 * ctx), num_steps=4, guidance_fn=gfn).numpy()
    assert (other != got).any()


def _stage1_cfg(ckpt=None, text=True):
    s1 = {"num_classes": 4, "time_steps": 20, "bf16": False,
          "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                          "num_head_channels": 4, "num_res_blocks": 1},
          "dataset": {"kind": "synthetic", "volume_shape": list(SHAPE[1:]), "num_cases": 4, "seed": 1}}
    if text:
        s1["feature_cond_encoder"] = REFINER
    if ckpt:
        s1["checkpoint"] = ckpt
    return s1


@pytest.mark.parametrize("batch_size", [1, 2])
def test_cli_stage_mask_with_text(tmp_path, text_models, capsys, batch_size):
    """`stage: mask` with `text.features_npz`: 3 cases (a ragged last batch
    at batch_size 2, padded with its last case), 2 draws each; files per
    case, Dice / GED / HM-IoU printed and returned, the labels those of the
    port's sampler run batch by batch on the same noise source."""
    _, _, tm, ckpt, ctx = text_models
    np.savez(tmp_path / "feat.npz", feats=ctx[0], other=np.zeros(3, np.float32))
    cfg = {"stage": "mask", "device": "cpu", "seed": 9, "n_cases": 3, "batch_size": batch_size, "samples": 2,
           "mask_steps": 3, "output_path": str(tmp_path / "out"), "text": {"features_npz": str(tmp_path / "feat.npz")},
           "stage1": _stage1_cfg(ckpt)}
    out = tcli.run(cfg)
    printed = capsys.readouterr().out
    assert out["labels"].shape == (3, 2, *SHAPE[1:])
    ds = build_mask_dataset(cfg["stage1"], "val")
    noise, want = NoiseSource(9, "cpu"), []
    for c0 in range(0, 3, batch_size):
        idx = [min(i, 2) for i in range(c0, c0 + batch_size)]
        cond = torch.from_numpy(np.stack([ds[i]["image"] for i in idx]))
        c = to_torch(ctx).expand(batch_size, -1, -1)
        draws = [tm.sample_labels(noise, (batch_size, *SHAPE[1:]), cond=cond, context=c, num_steps=3).numpy()
                 for _ in range(2)]
        want.append(np.stack(draws, 1)[:min(batch_size, 3 - c0)])
    np.testing.assert_array_equal(out["labels"], np.concatenate(want))
    for i, m in enumerate(out["metrics"]):
        gt = np.argmax(ds[i]["mask"], -1)
        assert m["ged"] == pytest.approx(jmetrics.generalized_energy_distance(out["labels"][i], gt[None], 4))
        assert m["hm_iou"] == pytest.approx(jmetrics.hungarian_matched_iou(out["labels"][i], np.stack([gt] * 2), 4))
        assert f"case {i}: mean fg dice {m['dice']:.4f} GED {m['ged']:.4f} HM-IoU {m['hm_iou']:.4f}" in printed
        cdir = tmp_path / "out" / f"case_{i:04d}"
        pred, _ = read_nifti(cdir / "pred.nii.gz")
        gt_file, _ = read_nifti(cdir / "gt.nii.gz")
        np.testing.assert_array_equal(pred, out["labels"][i, 0])
        np.testing.assert_array_equal(gt_file, gt)
        assert (cdir / "pred.png").stat().st_size > 0
    assert "3 case(s) in" in printed and "FRESH-INIT" not in printed


def test_cli_stage_mask_without_text(tmp_path, capsys):
    """The same branch without a feature encoder: one draw, no GED line."""
    cfg = {"stage": "mask", "device": "cpu", "seed": 2, "n_cases": 1, "mask_steps": 2,
           "output_path": str(tmp_path / "out"), "fresh_init_noise": 0.02, "stage1": _stage1_cfg(text=False)}
    out = tcli.run(cfg)
    printed = capsys.readouterr().out
    assert out["labels"].shape == (1, 1, *SHAPE[1:]) and "GED" not in printed and "FRESH-INIT" in printed
    assert out["metrics"][0].keys() == {"dice"} and 0.0 <= out["metrics"][0]["dice"] <= 1.0
    for name in ("pred.nii.gz", "pred.png", "gt.nii.gz"):
        assert (tmp_path / "out" / "case_0000" / name).is_file()


TWO_STAGE = {
    "stage": "two_stage", "device": "cpu", "seed": 5, "n_cases": 2, "batch_size": 2, "mask_steps": 3, "ddim_steps": 4,
    "volume_shape": [4, 16, 16], "chunk": 2,
    "stage2": {"slice_size": 16, "timesteps": 100, "bf16": False,
               "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                                          "num_head_channels": 4, "num_res_blocks": 1}}},
}


def test_cli_text_two_stage(tmp_path, text_models):
    """The text `two_stage`: the context, tiled over the batch of 2, goes to
    stage 1 only; the labels equal the port's chunked programs given the same
    context, and another context gives other labels."""
    _, _, tm, ckpt, ctx = text_models
    np.savez(tmp_path / "feat.npz", ctx[0])
    cfg = {**TWO_STAGE, "output_path": str(tmp_path / "out"), "text": {"features_npz": str(tmp_path / "feat.npz")},
           "stage1": _stage1_cfg(ckpt), "fresh_init_noise": 0.02}
    out = tcli.run(cfg)
    assert out["ct"].shape == (2, 4, 16, 16) and np.isfinite(out["ct"]).all()
    ldm, _, ddim, kw = tcli._stage2(cfg, cfg["stage2"], torch.device("cpu"), 5, 0.02)
    mask_program, _ = make_chunked_two_stage_programs(
        tm, ldm, mask_shape=(2, *SHAPE[1:]), volume_shape=(4, 16, 16), ddim=ddim, chunk=2, mask_steps=3,
        cond=torch.zeros((2, *SHAPE[1:], 1)), context=to_torch(ctx).expand(2, -1, -1), **kw)
    with torch.inference_mode():
        labels, _ = mask_program(NoiseSource(5, "cpu"))
    np.testing.assert_array_equal(out["labels"], labels.numpy())
    np.savez(tmp_path / "other.npz", -3 * ctx[0])
    other = tcli.run({**cfg, "text": {"features_npz": str(tmp_path / "other.npz")}})
    assert (other["labels"] != out["labels"]).any()
    for i in range(2):
        assert (tmp_path / "out" / f"case_{i:04d}" / "pred.nii.gz").is_file()


def test_loader_checks_every_leaf(tmp_path, text_models):
    """A JAX tree initialised without a context shape sizes attn2's to_k /
    to_v from the query width: the loader names that leaf and reshapes
    nothing.  A tree without the refiner lacks its leaves."""
    jm, p, tm, _, _ = text_models
    lazy = init_flax(jm.unet, jnp.zeros((*SHAPE, 4)), jnp.zeros((1,)), cond=jnp.zeros((*SHAPE, 1)))
    bad = _save({"unet": {"params": lazy}, "refiner": jax.device_get(p["refiner"])}, tmp_path / "lazy.npz")
    with pytest.raises(ValueError, match=r"attn2\.to_k\.weight.*context's shape"):
        tcli.load_mask_weights(tm, bad, 0.0, 0)
    no_refiner = _save(jax.device_get(p["unet"]), tmp_path / "unet_only.npz")
    with pytest.raises(ValueError, match="lacks refiner"):
        tcli.load_mask_weights(tm, no_refiner, 0.0, 0)
    with pytest.raises(ValueError, match="2D"):  # dino features are 2D; this stage 1 is 3D
        tcli.run({"stage": "mask", "device": "cpu",
                  "stage1": {**_stage1_cfg(), "feature_cond_encoder": {"type": "dino"}}})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ged_and_hm_iou_match_jax(seed):
    rs = np.random.RandomState(seed)
    samples, refs = rs.randint(0, 5, (3, 4, 6, 6)), rs.randint(0, 5, (2, 4, 6, 6))
    samples[0, samples[0] == 2] = 0  # a class absent from one sample
    for ignore in ((0,), ()):
        np.testing.assert_allclose(tmetrics.iou_distance_matrix(samples, refs, 5, ignore),
                                   jmetrics.iou_distance_matrix(samples, refs, 5, ignore), rtol=0, atol=1e-12)
        assert tmetrics.generalized_energy_distance(samples, refs, 5, ignore) == pytest.approx(
            jmetrics.generalized_energy_distance(samples, refs, 5, ignore), abs=1e-12)
        assert tmetrics.hungarian_matched_iou(samples, refs[[0, 1, 0]], 5, ignore) == pytest.approx(
            jmetrics.hungarian_matched_iou(samples, refs[[0, 1, 0]], 5, ignore), abs=1e-12)
    empty = np.zeros((1, 2, 2, 2), np.int64)
    assert tmetrics.iou_distance_matrix(empty, empty, 3)[0, 0] == 0.0  # background only: no class to compare
    assert tmetrics.hungarian_matched_iou(samples, samples, 5) == pytest.approx(1.0)
