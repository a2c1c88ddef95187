"""Sampling CLI: `stage: two_stage` (stage-1 mask volume -> stage-2 CT volume)
or `stage: ct` (stage 2 alone, on the slice dataset's masks).

    python -m jointimagegeneration_torch.cli.sample <config.yml> [k=v ...] [device=cpu]

Reads the keys of `configs/sample_two_stage.yml` and `configs/sample_ct_ae.yml`
(the JAX CLI's format) and writes per case, under `output_path`,
`case_XXXX/image.nii.gz` and `image.png`, with `overlay.png` (the labels over
the CT); `two_stage` adds `pred.nii.gz` and `pred.png`.  Runs on CUDA unless
`device=cpu` is given.  `run(cfg)` is the same entry point for a config that
is already a dict.

Stage 2 is the pixel-space SliceLDM, or with `stage2.first_stage` (and a
`cond_stage`) the latent `_ae` route (`models/latent_ldm.py`): the KL-VAEs
encode each [previous slice | mask slice] pair and decode each latent slice.
The stage-2 options of the JAX CLI, read at the top level or under `stage2`:
`sampler` (ddim, plms or dpm), `warm_start`, `guidance_scale`,
`ddim_discretize` (uniform, quad or uniform_lambda), and for `stage: ct` on
the pixel route `tile: {patch, stride}` (the latent route ignores it and
says so).  `stage: ct` computes the three-view LPIPS of each case against the
dataset's volume (`metrics`, default on; `lpips_weights` names calibrated
weights) and writes `metrics.json`.

Keys beyond the JAX CLI's:
  * `chunk: N` runs the two-stage stage 2 in chunks of N slices, each seeded
    with the previous chunk's last slice;
  * `slices: N` generates only the first N CT slices (image and pred are then
    N slices deep), a multiple of `chunk`; under `stage: ct` it cuts the
    dataset's volume;
  * `fresh_init_noise: s` fills the zero-initialised kernels of fresh-init
    weights (the UNets' and the AEs') with N(0, s^2), so that every layer of a
    random network carries signal (smoke runs; checkpoints are unaffected).

Weights come from a flat `.npz` of the JAX parameter tree ('/'-joined keys)
given as `stage1.checkpoint` / `stage2.checkpoint`, and for the AEs as
`first_stage.checkpoint` / `cond_stage.checkpoint` (`cli/common.py`); without
one the sampler uses a seeded fresh init and says so.  Not ported here:
`stage: mask`, FVD (two or more `stage: ct` cases with metrics), text
context, stage-2 context or class conditioning, and `tile` on `two_stage`
(which the JAX CLI never passes); asking for them raises.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.config import load_yaml_config
from ..core.runtime import configure_precision, resolve_device, synchronize
from ..data.nifti import save_image_volume, save_label_volume
from ..diffusion.ddim import DDIMParams
from ..diffusion.noise import NoiseSource
from ..eval.writers import image_volume_to_grid, labels_to_grid, overlay_volume_to_grid, save_grid_png
from ..models.mask_sampler import MaskSampler
from ..models.slice_ldm import SliceLDM
from ..nn.unet import UNet
from ..pipeline.two_stage import make_chunked_two_stage_programs
from ..utils.jax_weights import unet_state_dict_from_jax
from .common import build_latent_ldm, build_slice_dataset, fill_zero_init

__all__ = ["build_mask_sampler", "build_slice_ldm", "load_weights", "run", "main"]


def build_mask_sampler(cfg: dict, device, cond_channels: int = 1, seed: int = 0,
                       **unet_options) -> MaskSampler:
    """cfg keys mirror ccdm params.yml (unet_openai + diffusion sections);
    `seed` seeds the UNet's fresh init.  `unet_options` (`use_fused_resblock`,
    `use_pallas_conv`) go to `MaskSampler.create`; no config key sets them,
    as in the JAX CLI."""
    u = cfg.get("unet_openai", {})
    return MaskSampler.create(
        num_classes=cfg.get("num_classes", 12),
        cond_channels=cond_channels,
        time_steps=cfg.get("time_steps", 1000),
        schedule=cfg.get("beta_schedule", "cosine"),
        model_channels=u.get("base_channels", 64),
        channel_mult=tuple(u.get("channel_mult", (1, 2, 2, 4, 5))),
        attention_resolutions=tuple(u.get("attention_resolutions", (32, 16, 8))),
        num_res_blocks=u.get("num_res_blocks", 2),
        num_head_channels=u.get("num_head_channels", 32),
        dims=cfg.get("dims", 3),
        dtype=torch.bfloat16 if cfg.get("bf16", True) else torch.float32,
        step_T_sample=cfg.get("step_T_sample", "majority"),
        device=device,
        seed=seed,
        **unet_options,
    )


def build_slice_ldm(cfg: dict, device, seed: int = 1, **options) -> SliceLDM:
    """cfg keys mirror the LDM yaml model.params section; `seed` seeds the
    UNet's fresh init (1 for sampling, the run's seed for training), and
    `options` (`learn_logvar`, `logvar_init`) go to `SliceLDM.create`."""
    u = cfg.get("unet_config", {}).get("params", cfg.get("unet", {}))
    return SliceLDM.create(
        image_channels=cfg.get("channels", 1),
        cond_channels=cfg.get("cond_channels", 2),
        timesteps=cfg.get("timesteps", 1000),
        beta_schedule=cfg.get("beta_schedule", "linear"),
        linear_start=cfg.get("linear_start", 0.0015),
        linear_end=cfg.get("linear_end", 0.0195),
        model_channels=u.get("model_channels", 128),
        channel_mult=tuple(u.get("channel_mult", (1, 2, 4, 4, 5))),
        attention_resolutions=tuple(u.get("attention_resolutions", (32, 16, 8))),
        num_res_blocks=u.get("num_res_blocks", 2),
        num_head_channels=u.get("num_head_channels", 32),
        dtype=torch.bfloat16 if cfg.get("bf16", True) else torch.float32,
        device=device,
        seed=seed,
        **options,
    )


def _reject_unported(cfg: dict, s1: dict, s2: dict, stage: str) -> None:
    def bad(what: str):
        raise NotImplementedError(f"{what} is not ported to the PyTorch sampler yet")

    if stage not in ("mask", "ct", "two_stage"):
        raise ValueError(f"unknown stage {stage!r}: expected 'mask', 'ct', or 'two_stage'")
    if stage == "mask":
        bad("stage 'mask'")
    if stage == "ct" and cfg.get("metrics", True) and int(cfg.get("n_cases", 1)) >= 2:
        bad("FVD over two or more cases (set metrics: false, or n_cases: 1)")
    if stage == "two_stage" and (cfg.get("text") or (s1.get("feature_cond_encoder") or {}).get("type")):
        bad("text / feature conditioning")
    u2 = s2.get("unet_config", {}).get("params", s2.get("unet", {}))
    if u2.get("context_dim") is not None or u2.get("num_classes", s2.get("adm_classes")) is not None:
        bad("stage-2 context / class conditioning")
    if stage == "two_stage" and (cfg.get("tile") or s2.get("tile")):
        bad("tile on two_stage (a `stage: ct` key)")


def load_weights(unet: UNet, ckpt: Optional[str], fresh_init_noise: float, seed: int) -> None:
    """Load `ckpt` (a flat .npz of the JAX UNet tree) into `unet`; without one,
    keep the fresh init and fill its zero-initialised kernels with
    N(0, fresh_init_noise^2) drawn from `seed`."""
    if ckpt:
        if not str(ckpt).endswith(".npz"):
            raise ValueError(f"checkpoint {ckpt!r}: the PyTorch sampler reads a flat .npz of the "
                             "JAX UNet parameter tree")
        unet.load_state_dict(unet_state_dict_from_jax(ckpt))
        return
    print("WARNING: no checkpoint configured — sampling with FRESH-INIT (random) weights")
    if fresh_init_noise:
        fill_zero_init(unet, fresh_init_noise, seed)


def _stage2(cfg: dict, s2: dict, device, seed: int, noise_std: float):
    """(pixel SliceLDM, LatentSliceLDM or None, DDIMParams, sampler options)."""
    ldm = build_slice_ldm(s2, device)
    load_weights(ldm.unet, s2.get("checkpoint"), noise_std, seed + 2)
    latent, _ = build_latent_ldm(s2, ldm, int(s2.get("slice_size", 512)), device, noise_std, seed + 3)
    ddim = DDIMParams.create(ldm.diffusion, int(cfg.get("ddim_steps", 50)),
                             method=cfg.get("ddim_discretize", s2.get("ddim_discretize", "uniform")),
                             eta=float(cfg.get("ddim_eta", 0.0)))
    sample_kw = {"sampler": cfg.get("sampler", s2.get("sampler", "ddim")),
                 "warm_start": cfg.get("warm_start", s2.get("warm_start")),
                 "guidance_scale": float(cfg.get("guidance_scale", s2.get("guidance_scale", 1.0)))}
    return ldm, latent, ddim, sample_kw


def _write_case(cdir: Path, ct: np.ndarray, labels: Optional[np.ndarray], pred: bool) -> None:
    """image.nii.gz and image.png; with labels of the CT's shape overlay.png;
    with `pred` also pred.nii.gz and pred.png."""
    cdir.mkdir(parents=True, exist_ok=True)
    save_image_volume(cdir / "image.nii.gz", ct)
    save_grid_png(cdir / "image.png", image_volume_to_grid(ct))
    if pred:
        save_label_volume(cdir / "pred.nii.gz", labels)
        save_grid_png(cdir / "pred.png", labels_to_grid(labels))
    if labels is not None and labels.shape == ct.shape:
        save_grid_png(cdir / "overlay.png", overlay_volume_to_grid(ct, labels))


def run(cfg: dict, device=None) -> dict:
    """Sample `n_cases` volumes and write them.  `two_stage` returns {"ct":
    (n_cases, D, H, W) float32, "labels": (n_cases, D', H', W') int,
    "seconds": {"stage1", "stage2"}, "output_path": Path}; `ct` and the
    written pred.nii.gz cover the generated slices, `labels` the whole grid.
    `ct` returns {"ct", "seconds": {"stage2"}, "metrics" (the metrics.json
    dict or None), "output_path"}."""
    device = resolve_device(cfg.get("device", device))
    configure_precision()
    stage = cfg.get("stage", "two_stage")
    s1, s2 = cfg.get("stage1", cfg), cfg.get("stage2", cfg)
    if "step_T_sample" in cfg and "step_T_sample" not in s1:
        s1 = {**s1, "step_T_sample": cfg["step_T_sample"]}
    _reject_unported(cfg, s1, s2, stage)

    outdir = Path(cfg.get("output_path", "samples"))
    outdir.mkdir(parents=True, exist_ok=True)
    seed = int(cfg.get("seed", 1024))
    noise_std = float(cfg.get("fresh_init_noise", 0.0))
    if stage == "ct":
        return _run_ct(cfg, s2, device, seed, noise_std, outdir)
    n_cases = int(cfg.get("n_cases", 1))
    spatial = tuple(s1.get("dataset", {}).get("volume_shape", (64, 128, 128)))
    vshape = tuple(cfg.get("volume_shape", (128, 256, 256)))
    n_slices = int(cfg.get("slices", vshape[0]))
    chunk = int(cfg.get("chunk", n_slices))
    if not 0 < n_slices <= vshape[0] or n_slices % chunk:
        raise ValueError(f"slices ({n_slices}) must be in [1, {vshape[0]}] and a multiple of chunk ({chunk})")

    ms = build_mask_sampler(s1, device)
    load_weights(ms.unet, s1.get("checkpoint"), noise_std, seed + 1)
    ldm, latent, ddim, sample_kw = _stage2(cfg, s2, device, seed, noise_std)
    noise = NoiseSource(seed, device)
    bs = max(1, min(int(cfg.get("batch_size", 1)), n_cases))
    cts, labels_all = [], []
    seconds = {"stage1": 0.0, "stage2": 0.0}
    with torch.inference_mode():
        for c0 in range(0, n_cases, bs):
            b = min(bs, n_cases - c0)
            # zero image condition, as the JAX CLI's two_stage branch
            cond = torch.zeros((b, *spatial, 1), device=device)
            mask_program, chunk_program = make_chunked_two_stage_programs(
                ms, latent or ldm, mask_shape=(b, *spatial), volume_shape=vshape, ddim=ddim, chunk=chunk,
                mask_steps=cfg.get("mask_steps", 250), cond=cond, **sample_kw)
            t0 = time.perf_counter()
            labels, mask_channel = mask_program(noise)
            synchronize(device)
            t1 = time.perf_counter()
            vols, last = [], None
            for z0 in range(0, n_slices, chunk):
                vol, last = chunk_program(noise, mask_channel[:, z0:z0 + chunk], last)
                vols.append(vol)
            ct = torch.cat(vols, dim=1)[..., 0].float().cpu().numpy()
            t2 = time.perf_counter()
            seconds["stage1"] += t1 - t0
            seconds["stage2"] += t2 - t1
            labels = labels.cpu().numpy()
            for j in range(b):
                _write_case(outdir / f"case_{c0 + j:04d}", ct[j], labels[j, :n_slices], pred=True)
            cts.append(ct)
            labels_all.append(labels)
    print(f"{n_cases} case(s): stage 1 {seconds['stage1']:.2f}s, stage 2 {seconds['stage2']:.2f}s "
          f"({n_slices} slices x {ddim.num_steps} {sample_kw['sampler']} nodes"
          f"{', latent' if latent is not None else ''}) on {device}")
    return {"ct": np.concatenate(cts), "labels": np.concatenate(labels_all), "seconds": seconds,
            "output_path": outdir}


def _run_ct(cfg: dict, s2: dict, device, seed: int, noise_std: float, outdir: Path) -> dict:
    """`stage: ct`: per case the dataset's mask volume -> a CT volume, its
    files, and the three-view LPIPS against the dataset's volume."""
    n_cases = int(cfg.get("n_cases", 1))
    ldm, latent, ddim, sample_kw = _stage2(cfg, s2, device, seed, noise_std)
    tcfg = cfg.get("tile") or s2.get("tile")
    tile = None
    if tcfg and latent is not None:
        print("WARNING: `tile:` is ignored on the latent ct path "
              "(latents are already small; first-stage tiling is built in)")
    elif tcfg:
        tile = (tuple(tcfg["patch"]), tuple(tcfg.get("stride", tcfg["patch"])))
    ds = build_slice_dataset(s2, cfg.get("split", "val"))
    nc = int(cfg.get("num_classes", s2.get("num_classes", 12)))
    noise = NoiseSource(seed, device)
    lp_metric, lpips_vals, cts, seconds = None, [], [], 0.0
    with torch.inference_mode():
        for i in range(n_cases):
            item = ds[i % len(ds)]
            depth = item["wholemask"].shape[0]
            n = int(cfg.get("slices", depth))
            if not 0 < n <= depth:
                raise ValueError(f"slices ({n}) must be in [1, {depth}]")
            mask = torch.from_numpy(item["wholemask"][:n]).to(device)[None]
            t0 = time.perf_counter()
            if latent is not None:
                vol = latent.sample_volume(noise, mask, ddim, **sample_kw)
            else:
                vol = ldm.sample_volume(noise, mask, ddim, tile=tile, **sample_kw)
            vol = vol[0, ..., 0].float().cpu().numpy()
            seconds += time.perf_counter() - t0
            labels = np.rint(item["wholemask"][:n, ..., 0] * (nc - 1)).astype(np.int64)
            _write_case(outdir / f"case_{i:04d}", vol, labels, pred=False)
            cts.append(vol)
            gt = item.get("wholeimage")
            if cfg.get("metrics", True) and gt is not None and gt[:n].shape[:-1] == vol.shape:
                if lp_metric is None:
                    from ..eval.lpips import LPIPS

                    lp_metric = LPIPS(cfg.get("lpips_weights"), device=device)
                    if not cfg.get("lpips_weights"):
                        print("NOTE: lpips_weights not configured — LPIPS uses an "
                              "uncalibrated VGG (relative comparisons only)")
                from ..eval.lpips import lpips_three_view

                val = float(lpips_three_view(lp_metric, torch.from_numpy(vol), torch.from_numpy(gt[:n, ..., 0])))
                lpips_vals.append(val)
                print(f"case {i}: lpips_3view {val:.4f}")
    summary = None
    if lpips_vals:
        summary = {"lpips_three_view_mean": float(np.mean(lpips_vals)), "lpips_per_case": lpips_vals}
        (outdir / "metrics.json").write_text(json.dumps(summary, indent=1))
        print("metrics:", {k: v for k, v in summary.items() if k != "lpips_per_case"})
    print(f"{n_cases} case(s): stage 2 {seconds:.2f}s ({cts[0].shape[0]} slices x {ddim.num_steps} "
          f"{sample_kw['sampler']} nodes{', latent' if latent is not None else ''}) on {device}")
    return {"ct": np.stack(cts), "seconds": {"stage2": seconds}, "metrics": summary, "output_path": outdir}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    run(load_yaml_config(argv[0], overrides=argv[1:]))


if __name__ == "__main__":
    main()
