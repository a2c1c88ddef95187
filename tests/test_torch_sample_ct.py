"""PyTorch port: `cli.sample.run` with `stage: ct` (pixel and latent) and the
latent `two_stage`, on the CPU at tiny widths.

The CLI's volumes against the same models driven directly (same `build_*`,
same fresh-init seeds, same noise stream: equal within 1e-6), the files per
case (image.nii.gz, image.png, overlay.png; pred.* on two_stage),
metrics.json with a finite three-view LPIPS, the AE weights from a flat
`.npz` of the JAX AE variables (under `params` or `g_params`), the latent
scale factor from `latent_scale.json`, and the guards that raise."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import sample as tcli
from jointimagegeneration_torch.cli.common import build_latent_ldm, build_slice_dataset
from jointimagegeneration_torch.diffusion.ddim import DDIMParams
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.pipeline.two_stage import TwoStagePipeline
from jointimagegeneration_torch.utils.jax_weights import ae_state_dict_from_jax, flatten_tree
from jointimagegeneration_tpu.data.nifti import read_nifti
from jointimagegeneration_tpu.models.autoencoder import AutoencoderKL

from test_torch_weights import init_flax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UNET = {"model_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2], "num_head_channels": 4,
        "num_res_blocks": 1}


def _ae(cin):
    return {"embed_dim": 4, "ddconfig": {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [8],
                                         "z_channels": 4, "in_channels": cin, "out_ch": cin, "resolution": 16}}


def _ct_cfg(tmp_path, latent: bool, **top):
    """configs/sample_ct_ae.yml's keys (or its pixel twin) at tiny widths."""
    s2 = {"slice_size": 16, "timesteps": 100, "bf16": False, "unet_config": {"params": UNET},
          "dataset": {"kind": "synthetic", "slice_shape": [16, 16], "depth": 3, "num_cases": 2}}
    if latent:
        s2.update(channels=4, cond_channels=4, first_stage=_ae(1), cond_stage=_ae(2))
    return {"stage": "ct", "output_path": str(tmp_path / "out"), "n_cases": 1, "ddim_steps": 4, "seed": 3,
            "device": "cpu", "fresh_init_noise": 0.02, "stage2": s2, **top}


def _direct(cfg):
    """The stage-2 model the CLI builds, its DDIMParams and sampler options."""
    s2 = cfg["stage2"]
    ldm = tcli.build_slice_ldm(s2, "cpu")
    tcli.load_weights(ldm.unet, s2.get("checkpoint"), cfg["fresh_init_noise"], cfg["seed"] + 2)
    latent, size = build_latent_ldm(s2, ldm, s2["slice_size"], "cpu", cfg["fresh_init_noise"], cfg["seed"] + 3)
    ddim = DDIMParams.create(ldm.diffusion, cfg["ddim_steps"], method=cfg.get("ddim_discretize", "uniform"))
    kw = {k: cfg[k] for k in ("sampler", "warm_start", "guidance_scale") if k in cfg}
    return ldm, latent, size, ddim, kw


def _files(case_dir, names):
    return all((case_dir / n).stat().st_size > 60 for n in names)


@pytest.mark.parametrize("latent,extra", [
    (False, {"tile": {"patch": [8, 8], "stride": [4, 4]}}),
    (False, {"sampler": "dpm", "warm_start": 0.5}),
    (True, {}),
    (True, {"sampler": "dpm", "warm_start": 0.5, "guidance_scale": 2.0, "ddim_discretize": "uniform_lambda"}),
], ids=["pixel-tile", "pixel-dpm-warm", "latent", "latent-dpm-warm-cfg"])
def test_ct_stage_matches_direct_drive(tmp_path, capsys, latent, extra):
    cfg = _ct_cfg(tmp_path, latent, **extra)
    out = tcli.run(cfg)
    text = capsys.readouterr().out
    assert text.count("FRESH-INIT") == (3 if latent else 1) and "uncalibrated VGG" in text
    ct = out["ct"]
    assert ct.shape == (1, 3, 16, 16) and np.isfinite(ct).all() and ct.min() >= 0.0 and ct.max() <= 1.0
    case = tmp_path / "out" / "case_0000"
    assert _files(case, ("image.nii.gz", "image.png", "overlay.png")) and not (case / "pred.nii.gz").exists()
    vol, _ = read_nifti(case / "image.nii.gz")
    np.testing.assert_array_equal(vol, ct[0])
    metrics = json.loads((tmp_path / "out" / "metrics.json").read_text())
    assert metrics == out["metrics"] and np.isfinite(metrics["lpips_three_view_mean"])
    assert metrics["lpips_per_case"] == [metrics["lpips_three_view_mean"]]
    # the same models driven directly
    ldm, lat, size, ddim, kw = _direct(cfg)
    assert size == (8 if latent else 16)
    mask = torch.from_numpy(build_slice_dataset(cfg["stage2"], "val")[0]["wholemask"])[None]
    with torch.inference_mode():
        if latent:
            want = lat.sample_volume(NoiseSource(3, "cpu"), mask, ddim, **kw)
        else:
            tile = ((8, 8), (4, 4)) if "tile" in extra else None
            want = ldm.sample_volume(NoiseSource(3, "cpu"), mask, ddim, tile=tile, **kw)
    np.testing.assert_allclose(ct[0], want[0, ..., 0].numpy(), atol=1e-6, rtol=0)


def test_ct_latent_ignores_tile_and_cuts_slices(tmp_path, capsys):
    out = tcli.run(_ct_cfg(tmp_path, True, tile={"patch": [8, 8]}, slices=2, metrics=False))
    assert "`tile:` is ignored on the latent ct path" in capsys.readouterr().out
    assert out["ct"].shape == (1, 2, 16, 16) and out["metrics"] is None
    assert not (tmp_path / "out" / "metrics.json").exists()
    out = tcli.run(_ct_cfg(tmp_path, False, n_cases=2, metrics=False))  # no FVD asked for: two cases run
    assert out["ct"].shape == (2, 3, 16, 16) and not np.array_equal(out["ct"][0], out["ct"][1])


def _ae_npz(tmp_path, name, cin, top="params", shape_of=None):
    """A flat .npz of JAX AE variables ('/'-joined keys under `top`)."""
    dd = _ae(cin)["ddconfig"]
    jm = AutoencoderKL(embed_dim=4, **{k: tuple(v) if isinstance(v, list) else v for k, v in dd.items()})
    p = init_flax(jm, jnp.zeros((1, 16, 16, cin)), seed=cin)
    if shape_of:
        p["quant_conv"]["kernel"] = np.zeros(shape_of, np.float32)
    flat = {"/".join(k): v for k, v in flatten_tree({top: {"params": p} if top == "g_params" else p}).items()}
    np.savez(tmp_path / name, **flat)
    return str(tmp_path / name), p


def test_ae_weights_scale_sidecar_and_guards(tmp_path):
    """AE weights from `params` and `g_params` npz files land where the bridge
    puts them; the scale factor comes from latent_scale.json beside the UNet
    .npz; wrong files and configs raise."""
    cfg = _ct_cfg(tmp_path, True, metrics=False)
    s2 = cfg["stage2"]
    fs_path, fs_p = _ae_npz(tmp_path, "fs.npz", 1)
    cs_path, cs_p = _ae_npz(tmp_path, "cs.npz", 2, top="g_params")
    s2["first_stage"] = {**s2["first_stage"], "checkpoint": fs_path}
    s2["cond_stage"] = {**s2["cond_stage"], "checkpoint": cs_path}
    unet_dir = tmp_path / "unet"
    unet_dir.mkdir()
    ldm = tcli.build_slice_ldm(s2, "cpu")
    (unet_dir / "latent_scale.json").write_text(json.dumps({"scale_factor": 0.25}))
    latent, size = build_latent_ldm({**s2, "checkpoint": str(unet_dir / "ema.npz")}, ldm, 16, "cpu")
    assert latent.scale_factor == 0.25 and size == 8
    for module, params in ((latent.first_stage, fs_p), (latent.cond_stage, cs_p)):
        for k, v in ae_state_dict_from_jax(params).items():
            assert torch.equal(module.state_dict()[k], v), k
    latent, _ = build_latent_ldm({**s2, "first_stage": {**s2["first_stage"], "scale_factor": 0.5}}, ldm, 16, "cpu")
    assert latent.scale_factor == 0.5
    assert build_latent_ldm({k: v for k, v in s2.items() if k != "first_stage"}, ldm, 16, "cpu") == (None, 16)
    bad_shape, _ = _ae_npz(tmp_path, "bad.npz", 1, shape_of=(1, 1, 8, 5))
    with pytest.raises(ValueError, match="shape"):
        build_latent_ldm({**s2, "first_stage": {**s2["first_stage"], "checkpoint": bad_shape}}, ldm, 16, "cpu")
    np.savez(tmp_path / "neither.npz", **{"opt_state/mu/x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="neither"):
        build_latent_ldm({**s2, "cond_stage": {**s2["cond_stage"], "checkpoint": str(tmp_path / "neither.npz")}},
                         ldm, 16, "cpu")
    with pytest.raises(ValueError, match="in_channels"):  # the cond encoder must take [prev, mask]
        build_latent_ldm({**s2, "cond_stage": _ae(1)}, ldm, 16, "cpu")
    with pytest.raises(ValueError, match="in_channels"):  # no cond stage: the 1-channel first stage would encode it
        tcli.run({**cfg, "stage2": {k: v for k, v in s2.items() if k != "cond_stage"}})
    out = tcli.run(cfg)  # the CLI with both AE files
    assert out["ct"].shape == (1, 3, 16, 16) and np.isfinite(out["ct"]).all()


@pytest.mark.parametrize("bad,err", [  # FVD, dino, tile on two_stage and stage-2 conditioning are ported
    ({"stage2": {"unet_config": {"params": {**UNET, "context_dim": 8}}}}, "context"),
])
def test_ct_guards_raise(tmp_path, bad, err):
    """A `context_dim` stage 2 samples without a context, as the JAX CLI
    (its attn2 sized from the site's width, as the JAX CLI's init sizes
    it); a class-conditional one raises ValueError naming the missing `y`
    before any step; an unknown stage raises."""
    s2 = _ct_cfg(tmp_path, True)["stage2"]
    out = tcli.run({**_ct_cfg(tmp_path, True), "stage2": {**s2, **bad["stage2"]}})
    assert np.isfinite(out["ct"]).all()
    adm = {**s2, "unet_config": {"params": {**UNET, "num_classes": 3}}}
    with pytest.raises(ValueError, match="class ids `y`"):
        tcli.run({**_ct_cfg(tmp_path, True), "stage2": adm})
    with pytest.raises(ValueError, match="unknown stage"):
        tcli.run({**_ct_cfg(tmp_path, True), "stage": "volume"})


TWO_STAGE = {
    "stage": "two_stage", "seed": 5, "n_cases": 1, "mask_steps": 3, "ddim_steps": 4, "volume_shape": [4, 16, 16],
    "chunk": 2, "fresh_init_noise": 0.02, "device": "cpu",
    "stage1": {"num_classes": 4, "time_steps": 20, "bf16": False,
               "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                               "num_head_channels": 4, "num_res_blocks": 1},
               "dataset": {"volume_shape": [4, 8, 8]}},
    "stage2": {"slice_size": 16, "timesteps": 100, "bf16": False, "channels": 4, "cond_channels": 4,
               "unet_config": {"params": UNET}, "first_stage": _ae(1), "cond_stage": _ae(2)},
}


def test_two_stage_tile_is_ignored_with_a_warning(tmp_path, capsys):
    """`tile:` on `stage: two_stage` (a `stage: ct` key, which the JAX CLI
    ignores there) warns and samples untiled: the volume and labels of the
    run without it, bit for bit."""
    s2 = {k: v for k, v in TWO_STAGE["stage2"].items() if k not in ("first_stage", "cond_stage")}
    cfg = {**TWO_STAGE, "stage2": {**s2, "channels": 1, "cond_channels": 2}, "output_path": str(tmp_path / "a")}
    ref = tcli.run(cfg)
    assert "`tile:` is ignored" not in capsys.readouterr().out
    got = tcli.run({**cfg, "output_path": str(tmp_path / "b"), "tile": {"patch": [8, 8], "stride": [4, 4]}})
    assert "WARNING: `tile:` is ignored on two_stage" in capsys.readouterr().out
    assert got["ct"].shape == (1, 4, 16, 16)
    np.testing.assert_array_equal(got["ct"], ref["ct"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])


def test_latent_two_stage_cli_matches_pipeline(tmp_path):
    """`two_stage` with `stage2.first_stage`: the latent stage 2 in two chunks,
    the labels and volume of one unchunked latent pipeline call, and the
    three PNGs of a case beside its NIfTI files."""
    cfg = {**TWO_STAGE, "output_path": str(tmp_path / "out")}
    out = tcli.run(cfg)
    case = tmp_path / "out" / "case_0000"
    assert _files(case, ("image.nii.gz", "pred.nii.gz", "image.png", "pred.png", "overlay.png"))
    ms = tcli.build_mask_sampler(cfg["stage1"], "cpu")
    tcli.load_weights(ms.unet, None, 0.02, cfg["seed"] + 1)
    _, latent, _, ddim, _ = _direct(cfg)
    with torch.inference_mode():
        ct, labels = TwoStagePipeline(ms, latent)(NoiseSource(5, "cpu"), mask_shape=(1, 4, 8, 8),
                                                  volume_shape=(4, 16, 16), ddim=ddim, mask_steps=3,
                                                  cond=torch.zeros((1, 4, 8, 8, 1)))
    np.testing.assert_array_equal(out["labels"], labels.numpy())
    # chunked: each chunk's first slice conditioned on the last decoded slice, as unchunked
    np.testing.assert_allclose(out["ct"], ct[..., 0].numpy(), atol=1e-6, rtol=0)


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    from jointimagegeneration_torch.eval.lpips import LPIPS
    from jointimagegeneration_torch.models.autoencoder import AutoencoderKL as TKL

    for fn in (lambda: tcli.run({"stage": "ct", "output_path": "unused"}), LPIPS, lambda: TKL(ch=8, ch_mult=(1,))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
