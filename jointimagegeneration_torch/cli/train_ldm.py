"""Stage-2 training CLI: the pixel-space slice LDM on synthetic slices.

    python -m jointimagegeneration_torch.cli.train_ldm <config.yml> <exp_name> [k=v ...] [device=cpu]

Reads the keys of `configs/stage2_ldm.yml` (the JAX CLI's format: run keys at
the top, the model under `model:`) and trains under `<output_path>/<exp_name>/`:
`metrics.jsonl`, `checkpoints/` (torch files, see core/checkpoint.py) and
`configs/run-config.json`.  Runs on CUDA unless `device=cpu` is given;
`run(cfg, exp)` is the same entry point for a config that is already a dict.
`resume: true` resumes from the latest checkpoint.

As the JAX CLI: AdamW with lr = accumulate_grad_batches x batch_size x
base_learning_rate (unless `scale_lr: false`), `model.scheduler` as the lr
schedule, `accumulate_grad_batches` as gradient accumulation, the LitEma
warmup EMA (0.9999), the learned per-timestep logvar with
`model.learn_logvar`, and the loss keys `loss_type`, `l_simple_weight`,
`original_elbo_weight`.  Validation runs on the EMA weights and the first
`n_log_images` validation items as one batch: the `SliceLDM.log_images`
panels (DDIM-`log_ddim_steps`, default 20, at most T/2; `log_progressive`
adds the full-T progression) written as PNGs under `<logdir>/images/`
(inputs, samples, inpaint, outpaint, denoise_row, progressive_row, and with a
2-channel cond one mask overlay per sample), drawn from the noise stream
seeded for (seed, step), their host seconds logged as `val/panel_seconds`;
then the l2 loss at t = T/2, logged as `val/loss_simple`, with the noise from
the stream seeded for (seed, step + 1); its negation ranks the best
checkpoints.

Rejected with NotImplementedError: the latent route (`first_stage`, `cond_stage`,
`scale_by_std`), `init_from` and `ckpt_path`, `model.remat`, datasets other
than `synthetic`, cross-attention `context_dim` and class conditioning (the
UNet's `num_classes`), and `profile_steps`.
"""

from __future__ import annotations

import sys
import time
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
from ..train.optim import build_optimizer
from ..train.state import EMATrainState
from ..train.steps import make_ldm_train_step
from ..train.trainer import Trainer, TrainerConfig, noise_seed
from .common import build_slice_dataset
from .sample import build_slice_ldm

__all__ = ["build_slice_dataset", "run", "main"]


def _reject_unported(cfg: dict, model_cfg: dict) -> None:
    def bad(what: str):
        raise NotImplementedError(f"{what} is not ported to the PyTorch trainer yet")

    for key in ("first_stage", "cond_stage", "scale_by_std"):
        if model_cfg.get(key):
            bad(f"the latent route ({key})")
    for key in ("init_from", "ckpt_path"):
        if cfg.get(key) or model_cfg.get(key):
            bad(key)
    if model_cfg.get("remat"):
        bad("remat")
    kind = cfg.get("dataset", {}).get("kind", "synthetic")
    if kind != "synthetic":
        bad(f"dataset kind {kind!r}")
    u = model_cfg.get("unet_config", {}).get("params", model_cfg.get("unet", {}))
    if u.get("context_dim") is not None:
        bad("cross-attention context (context_dim)")
    if u.get("num_classes", model_cfg.get("adm_classes")) is not None:
        bad("class conditioning (num_classes)")


def run(cfg: dict, exp: str = "exp", device=None) -> EMATrainState:
    """Train as the config says; returns the final train state."""
    device = resolve_device(cfg.get("device", device))
    configure_precision()
    model_cfg = cfg.get("model", cfg)
    _reject_unported(cfg, model_cfg)
    seed = int(cfg.get("seed", 0))
    model = build_slice_ldm(model_cfg, device, seed=seed, learn_logvar=bool(model_cfg.get("learn_logvar", False)),
                            logvar_init=float(model_cfg.get("logvar_init", 0.0)))
    batch_size = int(cfg.get("batch_size", 1))
    accumulate = int(cfg.get("accumulate_grad_batches", 1))
    lr = float(model_cfg.get("base_learning_rate", 2e-6))
    if cfg.get("scale_lr", True):
        lr = accumulate * batch_size * lr  # batch_size is the whole batch of a step
    named = model.named_parameters()
    print(f"stage-2 UNet params: {sum(p.numel() for _, p in named) / 1e6:.2f}M, lr={lr:.2e}")
    loader = DataLoader(build_slice_dataset(cfg, "train"), batch_size, seed=seed, device=device,
                        num_workers=int(cfg.get("num_workers", 2)))
    total_steps = int(cfg.get("max_steps", 100_000))
    sched = model_cfg.get("scheduler") or {}
    optimizer = build_optimizer(named, "AdamW", lr, lr_function=sched.get("type"), lr_params=sched.get("params"),
                                total_steps=total_steps, accumulate_steps=accumulate)
    state = EMATrainState(optimizer, ema_decay=0.9999, ema_warmup=True)
    step_fn = make_ldm_train_step(model, loss_type=model_cfg.get("loss_type", "l2"),
                                  l_simple_weight=float(model_cfg.get("l_simple_weight", 1.0)),
                                  elbo_weight=float(model_cfg.get("original_elbo_weight", 0.0)))
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
        if cond.shape[-1] == 2:  # [previous slice, mask slice]: the mask is labels / (C - 1)
            labels = np.rint(cond[..., 1].float().cpu().numpy() * (num_classes - 1)).astype(np.int64)
            samples = np.clip(panels["samples"][..., 0], 0, 1)
            logger.image(step, "val/overlay", make_grid(
                [overlay_mask_on_image(samples[i], labels[i]) for i in range(samples.shape[0])]))

    def eval_fn(state: EMATrainState, step: int, logger) -> float:
        items = [val_ds[i] for i in range(min(len(val_ds), int(cfg.get("n_log_images", 2))))]
        x0, cond = (torch.from_numpy(np.stack([it[k] for it in items])).to(device) for k in ("image", "cond"))
        t = torch.full((x0.shape[0],), diff.num_timesteps // 2, dtype=torch.int64, device=device)
        eps = NoiseSource(noise_seed(seed, step + 1), device).normal(x0.shape)
        with torch.no_grad(), state.ema_applied():
            t0 = time.perf_counter()
            panels = model.log_images(NoiseSource(noise_seed(seed, step), device), {"image": x0, "cond": cond},
                                      log_ddim, progressive=bool(cfg.get("log_progressive", False)))
            panel_seconds = time.perf_counter() - t0  # log_images returns host arrays: the device is done
            out = model.apply_model(diff.q_sample(x0, t, eps), t, cond=cond)
        target = eps if diff.parameterization == "eps" else x0
        val_loss = float(((out - target) ** 2).mean())
        if logger:
            log_panels(logger, step, panels, cond)
            logger.scalars(step, {"loss_simple": val_loss, "panel_seconds": panel_seconds}, prefix="val/")
        return -val_loss  # higher is better for the best-k checkpoints

    trainer = Trainer(
        TrainerConfig(
            logdir=f"{cfg.get('output_path', 'runs')}/{exp}",
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
