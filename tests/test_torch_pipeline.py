"""PyTorch port: the two-stage slice as a whole against the JAX package, the
chunked programs, and the port's sampling CLI, on the CPU.

Mask (1, 4, 16, 16) -> CT volume (6, 16, 16) with 8-channel UNets, 4 mask
steps and DDIM-4 in fp32, the JAX random draws replayed.  Labels must agree
on >= 99.9% of voxels (an argmax over near-tied classes may flip on
last-bit differences); the CT within 5e-4 (min-max normalised slices; the
fp32 UNets sum in another order at each of the 24 DDIM steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import sample as tcli
from jointimagegeneration_torch.diffusion.ddim import DDIMParams as TDDIM
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.pipeline.two_stage import TwoStagePipeline as TPipe
from jointimagegeneration_torch.pipeline.two_stage import make_chunked_two_stage_programs
from jointimagegeneration_tpu.data.nifti import read_nifti
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM
from jointimagegeneration_tpu.pipeline.two_stage import TwoStagePipeline

from test_torch_weights import ReplayNoise, init_flax, jax_mask_draws, jax_volume_draws, load_port, to_numpy

MASK_SHAPE, VOLUME = (1, 4, 16, 16), (6, 16, 16)
UNET = dict(model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
            num_head_channels=4)


@pytest.fixture(scope="module")
def slice_models():
    """(JAX pipeline, its params, port pipeline with the same weights)."""
    jm = MaskSampler.create(num_classes=4, time_steps=20, **UNET)
    js = SliceLDM.create(timesteps=100, **UNET)
    pm = init_flax(jm.unet, jnp.zeros((*MASK_SHAPE, 4)), jnp.zeros((1,)), cond=jnp.zeros((*MASK_SHAPE, 1)))
    ps = init_flax(js.unet, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, 16, 16, 2)), seed=1)
    tm = TMask.create(num_classes=4, time_steps=20, cond_channels=1, device="cpu", **UNET)
    ts = TSlice.create(timesteps=100, device="cpu", **UNET)
    load_port(tm.unet, pm)
    load_port(ts.unet, ps)
    return TwoStagePipeline(jm, js), (pm, ps), TPipe(tm, ts)


def _replay(key):
    k1, k2 = jax.random.split(key)  # two_stage.py:78
    return ReplayNoise(jax_mask_draws(k1, MASK_SHAPE, 4, 4) + jax_volume_draws(k2, 1, VOLUME[0], 16, 16, 1))


def test_two_stage_matches_jax(slice_models):
    jpipe, (pm, ps), tpipe = slice_models
    key = jax.random.key(21)
    cond = np.zeros((*MASK_SHAPE, 1), np.float32)
    ct_j, lab_j = jpipe({"params": pm}, {"params": ps}, key, mask_shape=MASK_SHAPE, volume_shape=VOLUME,
                        ddim=DDIMParams.create(jpipe.slice_ldm.diffusion, 4), mask_steps=4,
                        cond=jnp.asarray(cond))
    noise = _replay(key)
    ct_t, lab_t = tpipe(noise, mask_shape=MASK_SHAPE, volume_shape=VOLUME,
                        ddim=TDDIM.create(tpipe.slice_ldm.diffusion, 4), mask_steps=4,
                        cond=torch.from_numpy(cond))
    assert not noise.draws
    lab_j, ct_j = np.asarray(lab_j), np.asarray(ct_j)
    assert lab_t.shape == lab_j.shape == (1, *VOLUME) and ct_t.shape == ct_j.shape == (1, *VOLUME, 1)
    assert len(np.unique(lab_j)) > 1
    assert np.mean(lab_t.numpy() == lab_j) >= 0.999
    np.testing.assert_allclose(to_numpy(ct_t), ct_j, atol=5e-4, rtol=0)


def test_chunked_programs_equal_unchunked(slice_models):
    _, _, tpipe = slice_models
    ddim = TDDIM.create(tpipe.slice_ldm.diffusion, 4)
    cond = torch.zeros((*MASK_SHAPE, 1))
    ct, labels = tpipe(NoiseSource(9, "cpu"), mask_shape=MASK_SHAPE, volume_shape=VOLUME, ddim=ddim,
                       mask_steps=4, cond=cond)
    mask_program, chunk_program = make_chunked_two_stage_programs(
        tpipe.mask_sampler, tpipe.slice_ldm, mask_shape=MASK_SHAPE, volume_shape=VOLUME, ddim=ddim,
        chunk=3, mask_steps=4, cond=cond)
    noise = NoiseSource(9, "cpu")
    labels_c, mask_channel = mask_program(noise)
    v0, last = chunk_program(noise, mask_channel[:, :3], None)
    v1, _ = chunk_program(noise, mask_channel[:, 3:], last)
    assert torch.equal(labels_c, labels)
    assert torch.equal(torch.cat([v0, v1], dim=1), ct)
    with pytest.raises(ValueError):
        make_chunked_two_stage_programs(tpipe.mask_sampler, tpipe.slice_ldm, mask_shape=MASK_SHAPE,
                                        volume_shape=VOLUME, ddim=ddim, chunk=4)


TINY_YAML = """\
stage: two_stage
output_path: {out}
seed: 3
n_cases: 2
mask_steps: 4
ddim_steps: 4
volume_shape: [6, 16, 16]
chunk: 3
stage1:
  num_classes: 4
  time_steps: 20
  bf16: false
  unet_openai: {{base_channels: 8, channel_mult: [1, 2], attention_resolutions: [2], num_head_channels: 4, num_res_blocks: 1}}
  dataset: {{volume_shape: [4, 16, 16]}}
stage2:
  slice_size: 16
  timesteps: 100
  bf16: true
  unet_config:
    params: {{model_channels: 8, channel_mult: [1, 2], attention_resolutions: [2], num_head_channels: 4, num_res_blocks: 1}}
"""


def test_cli_writes_nifti_on_cpu(tmp_path, capsys):
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(TINY_YAML.format(out=tmp_path / "samples"))
    tcli.main([str(cfg_path), "device=cpu", "fresh_init_noise=0.02", "batch_size=2"])
    assert "FRESH-INIT" in capsys.readouterr().out
    for case in ("case_0000", "case_0001"):
        ct, _ = read_nifti(tmp_path / "samples" / case / "image.nii.gz")
        labels, _ = read_nifti(tmp_path / "samples" / case / "pred.nii.gz")
        assert ct.shape == labels.shape == (6, 16, 16)
        assert ct.dtype == np.float32 and labels.dtype == np.uint8
        assert np.isfinite(ct).all() and ct.min() >= 0.0 and ct.max() <= 1.0
        assert labels.max() < 4


def test_cli_checkpoint_and_unported_keys(tmp_path, slice_models):
    """Weights load from a flat .npz of the JAX tree ('/'-joined keys); the
    stage-2 sampler options give the pipeline's volume; keys the port does
    not cover raise."""
    from jointimagegeneration_torch.utils.jax_weights import flatten_tree

    _, (pm, ps), tpipe = slice_models
    import yaml

    cfg = yaml.safe_load(TINY_YAML.format(out=tmp_path / "s"))
    cfg.update(device="cpu", n_cases=1, slices=3)
    cfg["stage2"]["bf16"] = False
    for stage, params in (("stage1", pm), ("stage2", ps)):
        path = tmp_path / f"{stage}.npz"
        np.savez(path, **{"/".join(k): v for k, v in flatten_tree({"params": params}).items()})
        cfg[stage]["checkpoint"] = str(path)
    out = tcli.run(cfg)
    assert out["ct"].shape == (1, 3, 16, 16) and out["labels"].shape == (1, 6, 16, 16)
    ref = tpipe(NoiseSource(3, "cpu"), mask_shape=MASK_SHAPE, volume_shape=VOLUME,
                ddim=TDDIM.create(tpipe.slice_ldm.diffusion, 4), mask_steps=4,
                cond=torch.zeros((*MASK_SHAPE, 1)))
    np.testing.assert_array_equal(out["labels"], ref[1].numpy())
    np.testing.assert_allclose(out["ct"], to_numpy(ref[0])[:, :3, ..., 0], atol=1e-6)
    for opt in ({"sampler": "dpm"}, {"warm_start": 0.4}, {"guidance_scale": 3.0}):
        got = tcli.run({**cfg, **opt})["ct"]
        ref = tpipe(NoiseSource(3, "cpu"), mask_shape=MASK_SHAPE, volume_shape=VOLUME,
                    ddim=TDDIM.create(tpipe.slice_ldm.diffusion, 4), mask_steps=4,
                    cond=torch.zeros((*MASK_SHAPE, 1)), **opt)[0]
        np.testing.assert_allclose(got, to_numpy(ref)[:, :3, ..., 0], atol=1e-6, err_msg=str(opt))
    for bad in ({"stage1": {**cfg["stage1"], "feature_cond_encoder": {"type": "dino"}}},
                {"stage": "mask", "stage1": {**cfg["stage1"], "feature_cond_encoder": {"type": "dino"}}}):
        with pytest.raises(ValueError, match="2D"):  # dino features are 2D; this stage 1 is 3D
            tcli.run({**cfg, **bad})
    with pytest.raises(NotImplementedError):
        tcli.run({**cfg, "tile": {"patch": [8, 8]}})
    # the latent first stage is ported: without a cond stage, a 1-channel first
    # stage cannot encode the [prev, mask] pair, and the CLI says so
    with pytest.raises(ValueError, match="in_channels"):
        tcli.run({**cfg, "stage2": {**cfg["stage2"], "first_stage": {"ch": 8}}})
    with pytest.raises(ValueError):
        tcli.run({**cfg, "slices": 4})  # not a multiple of chunk 3
