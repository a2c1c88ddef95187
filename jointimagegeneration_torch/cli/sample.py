"""Two-stage sampling CLI: stage-1 mask volume -> stage-2 CT volume.

    python -m jointimagegeneration_torch.cli.sample <config.yml> [k=v ...] [device=cpu]

Reads the keys of `configs/sample_two_stage.yml` (the JAX CLI's format) and
writes `case_XXXX/{image,pred}.nii.gz` under `output_path`.  Runs on CUDA
unless `device=cpu` is given.  `run(cfg)` is the same entry point for a config
that is already a dict.

Keys beyond the JAX CLI's:
  * `chunk: N` runs stage 2 in chunks of N slices, each seeded with the
    previous chunk's last slice;
  * `slices: N` generates only the first N CT slices (image and pred are then
    N slices deep), a multiple of `chunk`;
  * `fresh_init_noise: s` fills the zero-initialised kernels of fresh-init
    weights with N(0, s^2), so that every layer of a random network carries
    signal (smoke runs; checkpoints are unaffected).

Weights come from a flat `.npz` of the JAX UNet parameter tree ('/'-joined
keys) given as `stage1.checkpoint` / `stage2.checkpoint`; without one the
sampler uses a seeded fresh init and says so.  Not ported here: stages other
than `two_stage`, the latent first stage, text context, samplers other than
DDIM, warm start, classifier-free guidance and tiling; asking for them raises.
"""

from __future__ import annotations

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
from ..models.mask_sampler import MaskSampler
from ..models.slice_ldm import SliceLDM
from ..nn.unet import ZERO_INIT_SUFFIXES, UNet
from ..pipeline.two_stage import make_chunked_two_stage_programs
from ..utils.jax_weights import unet_state_dict_from_jax

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


def build_slice_ldm(cfg: dict, device) -> SliceLDM:
    """cfg keys mirror the LDM yaml model.params section."""
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
        seed=1,
    )


def _reject_unported(cfg: dict, s1: dict, s2: dict) -> None:
    def bad(what: str):
        raise NotImplementedError(f"{what} is not ported to the PyTorch sampler yet")

    stage = cfg.get("stage", "two_stage")
    if stage != "two_stage":
        bad(f"stage {stage!r}")
    if s2.get("first_stage"):
        bad("the latent first stage (stage2.first_stage)")
    if cfg.get("text") or (s1.get("feature_cond_encoder") or {}).get("type"):
        bad("text / feature conditioning")
    u2 = s2.get("unet_config", {}).get("params", s2.get("unet", {}))
    if u2.get("context_dim") is not None or u2.get("num_classes", s2.get("adm_classes")) is not None:
        bad("stage-2 context / class conditioning")
    if cfg.get("sampler", s2.get("sampler", "ddim")) != "ddim":
        bad(f"sampler {cfg.get('sampler', s2.get('sampler'))!r}")
    if cfg.get("warm_start", s2.get("warm_start")) is not None:
        bad("warm_start")
    if float(cfg.get("guidance_scale", s2.get("guidance_scale", 1.0))) != 1.0:
        bad("guidance_scale != 1")
    if cfg.get("tile") or s2.get("tile"):
        bad("tile")


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
        device = next(unet.parameters()).device
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        with torch.no_grad():
            for name, p in unet.named_parameters():
                if name.endswith(ZERO_INIT_SUFFIXES):
                    p.normal_(0.0, float(fresh_init_noise), generator=g)


def run(cfg: dict, device=None) -> dict:
    """Sample `n_cases` two-stage volumes and write them.  Returns
    {"ct": (n_cases, D, H, W) float32, "labels": (n_cases, D', H', W') int,
    "seconds": {"stage1", "stage2"}, "output_path": Path}; `ct` and the
    written pred.nii.gz cover the generated slices, `labels` the whole grid."""
    device = resolve_device(cfg.get("device", device))
    configure_precision()
    s1, s2 = cfg.get("stage1", cfg), cfg.get("stage2", cfg)
    if "step_T_sample" in cfg and "step_T_sample" not in s1:
        s1 = {**s1, "step_T_sample": cfg["step_T_sample"]}
    _reject_unported(cfg, s1, s2)

    outdir = Path(cfg.get("output_path", "samples"))
    outdir.mkdir(parents=True, exist_ok=True)
    seed = int(cfg.get("seed", 1024))
    n_cases = int(cfg.get("n_cases", 1))
    spatial = tuple(s1.get("dataset", {}).get("volume_shape", (64, 128, 128)))
    vshape = tuple(cfg.get("volume_shape", (128, 256, 256)))
    n_slices = int(cfg.get("slices", vshape[0]))
    chunk = int(cfg.get("chunk", n_slices))
    if not 0 < n_slices <= vshape[0] or n_slices % chunk:
        raise ValueError(f"slices ({n_slices}) must be in [1, {vshape[0]}] and a multiple of chunk ({chunk})")
    noise_std = float(cfg.get("fresh_init_noise", 0.0))

    ms = build_mask_sampler(s1, device)
    load_weights(ms.unet, s1.get("checkpoint"), noise_std, seed + 1)
    ldm = build_slice_ldm(s2, device)
    load_weights(ldm.unet, s2.get("checkpoint"), noise_std, seed + 2)
    ddim = DDIMParams.create(ldm.diffusion, int(cfg.get("ddim_steps", 50)),
                             method=cfg.get("ddim_discretize", s2.get("ddim_discretize", "uniform")),
                             eta=float(cfg.get("ddim_eta", 0.0)))
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
                ms, ldm, mask_shape=(b, *spatial), volume_shape=vshape, ddim=ddim, chunk=chunk,
                mask_steps=cfg.get("mask_steps", 250), cond=cond)
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
                cdir = outdir / f"case_{c0 + j:04d}"
                cdir.mkdir(exist_ok=True)
                save_image_volume(cdir / "image.nii.gz", ct[j])
                save_label_volume(cdir / "pred.nii.gz", labels[j, :n_slices])
            cts.append(ct)
            labels_all.append(labels)
    print(f"{n_cases} case(s): stage 1 {seconds['stage1']:.2f}s, stage 2 {seconds['stage2']:.2f}s "
          f"({n_slices} slices x {ddim.num_steps} DDIM steps) on {device}")
    return {"ct": np.concatenate(cts), "labels": np.concatenate(labels_all), "seconds": seconds,
            "output_path": outdir}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    run(load_yaml_config(argv[0], overrides=argv[1:]))


if __name__ == "__main__":
    main()
