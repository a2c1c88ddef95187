"""PyTorch port: the panel writers, the PNG trail, the fast sampling preset and
the stage-2 trainer's validation panels, on the CPU.

The grid and overlay functions equal the JAX package's bit for bit; the
port's PNG encoder (standard library only) decodes, through PIL here, to the
array it was given and to what the JAX writer's PNG decodes to.  The tiny
fast preset through `cli.sample.run` equals the pipeline called directly
(within 1e-6: the CLI and the pipeline run the same code on the same draws).
The trainer's validation writes the panels and keeps `val/loss_simple` the
EMA weights' score on its own noise stream."""

import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from jointimagegeneration_torch.cli import sample as tcli
from jointimagegeneration_torch.cli import train_ldm as tldm
from jointimagegeneration_torch.cli.sample import build_mask_sampler, build_slice_ldm, load_weights
from jointimagegeneration_torch.core.logging import MetricLogger
from jointimagegeneration_torch.data import classes as tclasses
from jointimagegeneration_torch.diffusion.ddim import DDIMParams
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.eval import writers as tw
from jointimagegeneration_torch.pipeline.two_stage import TwoStagePipeline
from jointimagegeneration_tpu.data import classes as jclasses
from jointimagegeneration_tpu.eval import writers as jw

from test_torch_ldm_train import _tiny_cfg, _val_loss


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests: the tiny models gain
    nothing from more, and the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(seed, *shape, classes=12):
    return np.random.RandomState(seed).randint(0, classes, shape)


# --------------------------------------------------------------- writers --

def test_class_table_copied():
    assert tclasses.ABD_ORGAN_CLASSES == [tuple(c) for c in jclasses.ABD_ORGAN_CLASSES]
    assert tclasses.NUM_CLASSES == jclasses.NUM_CLASSES == 12
    np.testing.assert_array_equal(tclasses.class_color_map(), jclasses.class_color_map())
    lab = _labels(0, 5, 7, classes=15)  # ids past the table clip to its last class
    np.testing.assert_array_equal(tclasses.labels_to_colors(lab), jclasses.labels_to_colors(lab))


@pytest.mark.parametrize("n,ncols,pad", [(1, 8, 2), (5, 8, 2), (11, 4, 1), (3, 2, 0)])
def test_make_grid_equals_jax(n, ncols, pad):
    ims = [np.random.RandomState(i).randint(0, 256, (6, 9, 3)).astype(np.uint8) for i in range(n)]
    np.testing.assert_array_equal(tw.make_grid(ims, ncols=ncols, pad=pad), jw.make_grid(ims, ncols=ncols, pad=pad))


@pytest.mark.parametrize("shape,every", [((9, 8, 8), 4), ((3, 5, 6), 1), ((8, 8), 4)])
def test_volume_and_label_grids_equal_jax(shape, every):
    vol = np.random.RandomState(1).uniform(-0.2, 1.2, shape).astype(np.float32)  # clipped to [0, 1]
    np.testing.assert_array_equal(tw.image_volume_to_grid(vol, every), jw.image_volume_to_grid(vol, every))
    lab = _labels(2, *shape)
    np.testing.assert_array_equal(tw.labels_to_grid(lab, every), jw.labels_to_grid(lab, every))


@pytest.mark.parametrize("shape,coef,boundaries", [((16, 16), 0.2, True), ((4, 12, 12), 0.2, True),
                                                   ((16, 16), 0.5, False)])
def test_overlay_equals_jax(shape, coef, boundaries):
    image = np.random.RandomState(3).rand(*shape).astype(np.float32)
    lab = np.zeros(shape, np.int64)
    lab[..., 2:9, 3:10] = 4
    lab[..., 6:14, 8:12] = 7
    lab[..., 0, 0] = 11
    got = tw.overlay_mask_on_image(image, lab, overlay_coef=coef, boundaries=boundaries)
    np.testing.assert_array_equal(got, jw.overlay_mask_on_image(image, lab, overlay_coef=coef, boundaries=boundaries))
    with pytest.raises(ValueError):
        tw.overlay_mask_on_image(image, lab[..., :-1])


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (40, 33, 3), (5, 9)])
def test_png_encoder_round_trips_and_matches_jax_writer(tmp_path, shape):
    img = np.random.RandomState(4).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(_decode(tw.encode_png(img)), img)
    tw.save_grid_png(tmp_path / "sub" / "port.png", img)
    jw.save_grid_png(tmp_path / "jax.png", img)
    np.testing.assert_array_equal(_decode((tmp_path / "sub" / "port.png").read_bytes()),
                                  _decode((tmp_path / "jax.png").read_bytes()))


def test_png_encoder_rejects_other_layouts():
    for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4, 3), np.float32), np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError):
            tw.encode_png(bad)


def test_metric_logger_keeps_the_newest_30_pngs(tmp_path):
    img = np.zeros((4, 6, 3), np.uint8)
    log = MetricLogger(tmp_path)
    for step in range(25):
        log.image(step, "val/samples", img)
    log.image(24, "val/samples", img + 1)  # the same (name, step) again: one file, rewritten
    log.close()
    log = MetricLogger(tmp_path)  # a resumed run counts the files already there
    for step in range(25, 32):
        log.image(step, "val/inpaint", img)
    log.close()
    names = sorted(p.name for p in (tmp_path / "images").glob("*.png"))
    assert len(names) == 30
    # 32 written, the two oldest (steps 0 and 1) unlinked
    assert names == sorted([f"val_inpaint_gs-{s:06d}.png" for s in range(25, 32)]
                           + [f"val_samples_gs-{s:06d}.png" for s in range(2, 25)])
    assert _decode((tmp_path / "images" / "val_samples_gs-000024.png").read_bytes()).max() == 1


# ------------------------------------------------------- the fast preset --

FAST = {  # configs/sample_two_stage_fast.yml's keys at tiny widths
    "stage": "two_stage", "seed": 5, "n_cases": 1, "mask_steps": 4, "ddim_steps": 6,
    "ddim_discretize": "uniform_lambda", "sampler": "dpm", "ddim_eta": 0.0, "volume_shape": [4, 16, 16],
    "fresh_init_noise": 0.02, "device": "cpu",
    "stage1": {"num_classes": 4, "time_steps": 20, "bf16": False,
               "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                               "num_head_channels": 4, "num_res_blocks": 1},
               "dataset": {"volume_shape": [4, 8, 8]}},
    "stage2": {"slice_size": 16, "timesteps": 100, "bf16": False,
               "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                                          "num_head_channels": 4, "num_res_blocks": 1}}},
}


@pytest.mark.parametrize("opts", [{}, {"warm_start": 0.4}, {"sampler": "plms", "guidance_scale": 2.0},
                                  {"stage2": {**FAST["stage2"], "sampler": "plms", "warm_start": 0.5,
                                              "ddim_discretize": "quad"}}],
                         ids=["dpm", "dpm-warm", "plms-cfg", "stage2-keys"])
def test_fast_preset_cli_matches_pipeline(tmp_path, opts):
    """The CLI reads the stage-2 options at the top level or under stage2 and
    gives what the pipeline gives for them, called directly with the CLI's
    weights and noise stream."""
    cfg = {**FAST, **opts, "output_path": str(tmp_path / "out")}
    if "stage2" in opts:  # the top level would win
        del cfg["sampler"], cfg["ddim_discretize"]
    out = tcli.run(cfg)
    s1, s2 = cfg["stage1"], cfg["stage2"]
    ms, ldm = build_mask_sampler(s1, "cpu"), build_slice_ldm(s2, "cpu")
    load_weights(ms.unet, None, 0.02, cfg["seed"] + 1)
    load_weights(ldm.unet, None, 0.02, cfg["seed"] + 2)
    pick = lambda k, d: cfg.get(k, s2.get(k, d))  # noqa: E731
    ddim = DDIMParams.create(ldm.diffusion, 6, method=pick("ddim_discretize", "uniform"))
    ct, labels = TwoStagePipeline(ms, ldm)(
        NoiseSource(cfg["seed"], "cpu"), mask_shape=(1, 4, 8, 8), volume_shape=(4, 16, 16), ddim=ddim, mask_steps=4,
        cond=torch.zeros((1, 4, 8, 8, 1)), sampler=pick("sampler", "ddim"), warm_start=pick("warm_start", None),
        guidance_scale=pick("guidance_scale", 1.0))
    np.testing.assert_array_equal(out["labels"], labels.numpy())
    np.testing.assert_allclose(out["ct"], ct[..., 0].numpy(), atol=1e-6, rtol=0)
    assert out["ct"].shape == (1, 4, 16, 16) and np.isfinite(out["ct"]).all()
    assert out["ct"].min() >= 0.0 and out["ct"].max() <= 1.0
    assert (tmp_path / "out" / "case_0000" / "image.nii.gz").exists()


# --------------------------------------------------- the trainer's panels --

def test_ldm_cli_validation_writes_panels(tmp_path):
    """Validation at steps 2 and 4 writes inputs, samples, inpaint, outpaint,
    the denoise and progressive rows and the mask overlay (a 2-channel cond);
    val/loss_simple is still the EMA weights' score on the step + 1 stream."""
    cfg = _tiny_cfg(tmp_path / "runs", max_steps=4, log_ddim_steps=4, log_progressive=True)
    tldm.run(cfg, "p")
    logdir = tmp_path / "runs" / "p"
    names = sorted(p.name for p in (logdir / "images").glob("*.png"))
    panels = ("denoise_row", "inpaint", "inputs", "outpaint", "overlay", "progressive_row", "samples")
    assert names == sorted(f"val_{n}_gs-{s:06d}.png" for n in panels for s in (2, 4))
    shapes = {n: _decode((logdir / "images" / f"val_{n}_gs-000004.png").read_bytes()).shape for n in panels}
    # image_volume_to_grid shows every 4th of its leading axis (the JAX
    # trainer's call): the first sample, the first of 4 denoise steps, 2 of
    # the 7 progressive rows; the overlay has one panel per sample (pad 2)
    assert shapes["samples"] == shapes["inputs"] == shapes["denoise_row"] == (16, 16, 3)
    assert shapes["overlay"] == shapes["progressive_row"] == (16, 34, 3)
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    val = [r["val/loss_simple"] for r in recs if "val/loss_simple" in r]
    from jointimagegeneration_torch.core.checkpoint import CheckpointManager

    saved = CheckpointManager(logdir / "checkpoints").restore(4)
    np.testing.assert_allclose(val[-1], _val_loss(cfg, saved["ema"], 4), rtol=1e-6)
