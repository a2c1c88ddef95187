"""Stage-2 training CLI: the pixel-space slice LDM on CT slices.

    python -m jointimagegeneration_torch.cli.train_ldm <config.yml> <exp_name> [k=v ...] [device=cpu]

Reads the keys of `configs/stage2_ldm.yml` (the JAX CLI's format: run keys at
the top, the model under `model:`) and trains under `<output_path>/<exp_name>/`:
`metrics.jsonl`, `checkpoints/` (torch files, see core/checkpoint.py) and
`configs/run-config.json`.  Runs on CUDA unless `device=cpu` is given;
`run(cfg, exp)` is the same entry point for a config that is already a dict.
`resume: true` resumes from the latest checkpoint.  The data is
`dataset.kind` `synthetic`, `ruijin` (an index of NIfTI CT and label
volumes), `nnunet` (an nnUNet tree), or a stock kind: `lsun`, `imagenet`
(unconditional RGB, `cond_channels: 0`) or `imagenet_sr` (HR RGB with the
upsampled LR as a 3-channel cond, `configs/stage2_sr_imagenet.yml`), as
`cli/common.py` builds it: the loader reads the 'train' split, validation the
'val' split.  Under torchrun each process trains on batch_size / N rows of
the global `batch_size` and only rank 0 writes (`parallel/mesh.py`).

As the JAX CLI: AdamW with lr = accumulate_grad_batches x batch_size x
base_learning_rate (unless `scale_lr: false`), `model.scheduler` as the lr
schedule, `accumulate_grad_batches` as gradient accumulation, the LitEma
warmup EMA (0.9999), the learned per-timestep logvar with
`model.learn_logvar`, and the loss keys `loss_type`, `l_simple_weight`,
`original_elbo_weight`.  Validation runs on the EMA weights and the first
`n_log_images` validation items as one batch: the `SliceLDM.log_images`
panels (DDIM-`log_ddim_steps`, default 20, at most T/2; `log_progressive`
adds the full-T progression) written as PNGs under `<logdir>/images/`
(inputs, samples, inpaint, outpaint, denoise_row, progressive_row, channel 0
of an RGB image, and with a 2-channel cond one mask overlay per sample; items
without a cond are sampled from a zero one), drawn from the noise stream
seeded for (seed, step), their host seconds logged as `val/panel_seconds`;
then the l2 loss at t = T/2, logged as `val/loss_simple`, with the noise from
the stream seeded for (seed, step + 1); its negation ranks the best
checkpoints.

The latent (`_ae`) route (`configs/stage2_ldm_ae.yml`): a `model.first_stage`
section (and `model.cond_stage`) builds the frozen AEs with their weights
(`cli/common.build_latent_ldm`: a `cli.train_ae` checkpoint, a
`cli.convert_reference --ae` one or a JAX `.npz`); each step pushes the pixel
batch through them (`train/steps.make_latent_ldm_train_step`) and the UNet
trains at latent size.  `model.scale_by_std` calibrates the scale factor once,
1 / std of the first stage's mode over `train_ds[i]["image"]` for i <
batch_size, prints it and writes it to `<logdir>/checkpoints/latent_scale.json`,
which the sampler reads beside `stage2.checkpoint`.  Validation on this route
logs the inputs, their reconstructions and DDIM samples decoded to pixels,
then `val/loss_simple` in latent space (the first stage's mode, the cond
stage's mode of the condition).

Conditioning: the UNet config's `num_classes` trains the class-conditional
('adm') UNet on the batch's `class_label` (the stock `imagenet` kind's) or
`y`; validation passes the items' class ids to the panels and the val loss.
`context_dim` builds the cross-attention sites; the step reads a batch's
`context` (the stock datasets carry none, so through this CLI such a UNet
trains with attn2 over x itself, as the JAX CLI's).  `model.remat`
(`remat_policy`, `remat_levels`) rematerialises the UNet's ResBlocks;
`init_from` warm-starts the fresh parameters (`cli/common.maybe_init_from`;
ignored when `resume` is set); `ckpt_path` is not read, as the JAX CLI reads
none (`core/ref_import` points it at `init_from.path`); `profile_steps: N`
traces N steps (`train/trainer.py`).
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
from ..core.runtime import configure_precision, resolve_device
from ..data.classes import NUM_CLASSES
from ..data.loader import DataLoader
from ..diffusion.ddim import DDIMParams
from ..diffusion.noise import NoiseSource
from ..eval.writers import image_volume_to_grid, make_grid, overlay_mask_on_image
from ..parallel.mesh import is_chief, local_batch_size, maybe_initialize_distributed
from ..train.optim import build_optimizer
from ..train.state import EMATrainState
from ..train.steps import make_latent_ldm_train_step, make_ldm_train_step
from ..train.trainer import Trainer, TrainerConfig, noise_seed
from ..utils.misc import count_params
from .common import LATENT_SCALE_FILE, build_latent_ldm, build_slice_dataset, maybe_init_from
from .sample import build_slice_ldm

__all__ = ["build_slice_dataset", "run", "main"]


def run(cfg: dict, exp: str = "exp", device=None) -> EMATrainState:
    """Train as the config says; returns the final train state."""
    device = maybe_initialize_distributed(resolve_device(cfg.get("device", device)))
    configure_precision()
    model_cfg = cfg.get("model", cfg)
    seed = int(cfg.get("seed", 0))
    model = build_slice_ldm(model_cfg, device, seed=seed, learn_logvar=bool(model_cfg.get("learn_logvar", False)),
                            logvar_init=float(model_cfg.get("logvar_init", 0.0)))
    batch_size = int(cfg.get("batch_size", 1))
    accumulate = int(cfg.get("accumulate_grad_batches", 1))
    lr = float(model_cfg.get("base_learning_rate", 2e-6))
    if cfg.get("scale_lr", True):
        lr = accumulate * batch_size * lr  # batch_size is the whole batch of a step
    named = model.named_parameters()
    print(f"stage-2 UNet params: {count_params(p for _, p in named) / 1e6:.2f}M, lr={lr:.2e}")
    maybe_init_from(cfg, named, resume_key="resume")
    train_ds = build_slice_dataset(cfg, "train")
    logdir = Path(cfg.get("output_path", "runs")) / exp
    latent, _ = build_latent_ldm(model_cfg, model, int(cfg.get("dataset", {}).get("slice_shape", (512, 512))[0]),
                                 device, float(cfg.get("fresh_init_noise", 0.0)), seed + 3)
    if latent is not None and model_cfg.get("scale_by_std", False):
        calib = np.stack([np.asarray(train_ds[i]["image"]) for i in range(min(len(train_ds), batch_size))])
        latent = latent.calibrate_scale_factor(torch.from_numpy(calib).to(device))
        print(f"scale_by_std: calibrated scale_factor={latent.scale_factor!r}")
        if is_chief():
            ckdir = logdir / "checkpoints"
            ckdir.mkdir(parents=True, exist_ok=True)
            (ckdir / LATENT_SCALE_FILE).write_text(json.dumps({"scale_factor": latent.scale_factor}))
    loader = DataLoader(train_ds, local_batch_size(batch_size), seed=seed, device=device,
                        num_workers=int(cfg.get("num_workers", 2)))
    total_steps = int(cfg.get("max_steps", 100_000))
    sched = model_cfg.get("scheduler") or {}
    optimizer = build_optimizer(named, "AdamW", lr, lr_function=sched.get("type"), lr_params=sched.get("params"),
                                total_steps=total_steps, accumulate_steps=accumulate)
    state = EMATrainState(optimizer, ema_decay=0.9999, ema_warmup=True)
    step_kw = dict(loss_type=model_cfg.get("loss_type", "l2"),
                   l_simple_weight=float(model_cfg.get("l_simple_weight", 1.0)),
                   elbo_weight=float(model_cfg.get("original_elbo_weight", 0.0)))
    step_fn = (make_ldm_train_step(model, **step_kw) if latent is None
               else make_latent_ldm_train_step(latent, **step_kw))
    val_ds = build_slice_dataset(cfg, "val")
    diff = model.diffusion
    # at most T/2 steps: the +1 subset offset would index alphas_cumprod[T]
    log_ddim = DDIMParams.create(diff, min(int(cfg.get("log_ddim_steps", 20)), max(1, diff.num_timesteps // 2)),
                                 eta=float(cfg.get("ddim_eta", 0.0)))
    num_classes = int(cfg.get("num_classes", cfg.get("dataset", {}).get("num_classes", NUM_CLASSES)))

    def log_panels(logger, step: int, panels: dict, cond: torch.Tensor) -> None:
        for name in ("inputs", "samples", "inpaint", "outpaint"):
            logger.image(step, f"val/{name}", image_volume_to_grid(panels[name][..., 0]))
        for row in ("denoise_row", "progressive_row"):
            if row in panels:
                logger.image(step, f"val/{row}", image_volume_to_grid(panels[row][:, 0, ..., 0]))
        if cond is not None and cond.shape[-1] == 2:  # [previous slice, mask slice]: the mask is labels / (C - 1)
            labels = np.rint(cond[..., 1].float().cpu().numpy() * (num_classes - 1)).astype(np.int64)
            samples = np.clip(panels["samples"][..., 0], 0, 1)
            logger.image(step, "val/overlay", make_grid(
                [overlay_mask_on_image(samples[i], labels[i]) for i in range(samples.shape[0])]))

    def latent_eval(x0: torch.Tensor, cond: Optional[torch.Tensor], y: Optional[torch.Tensor], step: int,
                    logger) -> float:
        """Pixel panels (inputs, reconstructions, DDIM samples) and the latent
        val loss at t = T/2, as the JAX CLI's latent branch (without a cond,
        the samples' condition is zeros of the cond encoder's channels)."""
        t0 = time.perf_counter()
        z = latent.encode(x0)
        cond_z = None if cond is None else latent.encode_cond(cond)
        if cond is None:
            cond = torch.zeros(x0.shape[:-1] + ((latent.cond_stage or latent.first_stage).in_channels,),
                               device=device)
        panels = {"inputs": x0, "reconstruction": latent.decode(z),
                  "samples": latent.sample_slice(NoiseSource(noise_seed(seed, step), device), cond, log_ddim, y=y)}
        panels = {k: v[..., 0].float().cpu().numpy() for k, v in panels.items()}
        panel_seconds = time.perf_counter() - t0  # the numpy copies waited for the device
        t = torch.full((z.shape[0],), diff.num_timesteps // 2, dtype=torch.int64, device=device)
        eps = NoiseSource(noise_seed(seed, step + 1), device).normal(z.shape)
        out = model.apply_model(diff.q_sample(z, t, eps), t, cond=cond_z, y=y)
        val_loss = float(((out.float() - eps) ** 2).mean())
        if logger:
            for name, img in panels.items():
                logger.image(step, f"val/{name}", image_volume_to_grid(img))
            logger.scalars(step, {"loss_simple": val_loss, "panel_seconds": panel_seconds}, prefix="val/")
        return -val_loss

    def eval_fn(state: EMATrainState, step: int, logger) -> float:
        items = [val_ds[i] for i in range(min(len(val_ds), int(cfg.get("n_log_images", 2))))]
        # the stock lsun / imagenet items carry no cond: stack the keys present, as the JAX CLI; and the
        # class ids of an adm UNet (the JAX CLI's eval batch drops them, and its UNet's assert fires)
        batch = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items])).to(device)
                 for k in ("image", "cond", "y", "class_label") if k in items[0]}
        x0, cond = batch["image"], batch.get("cond")
        y = batch.get("y", batch.get("class_label"))
        if latent is not None:
            with torch.no_grad(), state.ema_applied():
                return latent_eval(x0, cond, y, step, logger)
        t = torch.full((x0.shape[0],), diff.num_timesteps // 2, dtype=torch.int64, device=device)
        eps = NoiseSource(noise_seed(seed, step + 1), device).normal(x0.shape)
        with torch.no_grad(), state.ema_applied():
            t0 = time.perf_counter()
            panels = model.log_images(NoiseSource(noise_seed(seed, step), device), batch, log_ddim,
                                      progressive=bool(cfg.get("log_progressive", False)))
            panel_seconds = time.perf_counter() - t0  # log_images returns host arrays: the device is done
            out = model.apply_model(diff.q_sample(x0, t, eps), t, cond=cond, y=y)
        target = eps if diff.parameterization == "eps" else x0
        val_loss = float(((out - target) ** 2).mean())
        if logger:
            log_panels(logger, step, panels, cond)
            logger.scalars(step, {"loss_simple": val_loss, "panel_seconds": panel_seconds}, prefix="val/")
        return -val_loss  # higher is better for the best-k checkpoints

    trainer = Trainer(
        TrainerConfig(
            logdir=str(logdir),
            max_steps=total_steps,
            log_every=int(cfg.get("display_freq", 50)),
            save_every=int(cfg.get("save_freq", 1000)),
            eval_every=int(cfg.get("eval_every", 5000)),
            save_weights_every=cfg.get("save_weights_every"),
            profile_steps=int(cfg.get("profile_steps", 0) or 0),
            seed=seed,
        ),
        state, step_fn, loader, device,
        eval_fn=eval_fn if cfg.get("validate", True) else None,
        resume=bool(cfg.get("resume")),
        run_config=cfg,
    )
    return trainer.fit()


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    exp = argv[1] if len(argv) > 1 and "=" not in argv[1] else "exp"
    overrides = [a for a in argv[1:] if "=" in a]
    run(load_yaml_config(argv[0], overrides=overrides), exp)


if __name__ == "__main__":
    main()
