"""Stage-1 training CLI: the categorical mask sampler on mask volumes.

    python -m jointimagegeneration_torch.cli.train_mask <config.yml> <exp_name> [k=v ...] [device=cpu]

Reads the keys of `configs/stage1_mask.yml` (the JAX CLI's format) and trains
under `<output_path>/<exp_name>/`: `metrics.jsonl`, `checkpoints/` (torch
files, see core/checkpoint.py) and `configs/run-config.json`.  Runs on CUDA
unless `device=cpu` is given; `run(cfg, exp)` is the same entry point for a
config that is already a dict.  `load_from: true` resumes from the latest
checkpoint.  Validation samples `n_validation_images` masks with the EMA
weights in `eval_time_steps` steps and logs their mean foreground Dice as
`val/dice`.

Text guidance: `feature_cond_encoder: {type: selfattn, embed_dim: D}` trains
the cross-attention UNet and the text refiner together (AdamW and the EMA
cover both; checkpoints and resume carry both), on synthetic cases whose
N(0, 1) context is (dataset.context_len (4), D); the refiner's dropout draws
come from the step's noise source, and validation passes each case's context
(no dropout).

Dense DINO features: a 2D config with `feature_cond_encoder: {type: dino,
inject_idx: N}` (`configs/stage1_mask_dino.yml`) trains the UNet widened at
that encoder site; the frozen ViT extractor (from the config's `seed` + 11,
or `weights_path`) maps each batch's `image` to the site's grid before the
step, and each validation item's image at validation.  The extractor has
no parameters in the train state.

Not ported here, and rejected with NotImplementedError: `remat`, `init_from`
and `profile_steps`.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..core.config import load_yaml_config
from ..core.runtime import configure_precision, resolve_device
from ..data.loader import DataLoader
from ..diffusion.noise import NoiseSource
from ..eval.metrics import per_class_dice
from ..train.optim import build_optimizer
from ..train.state import EMATrainState
from ..train.steps import make_mask_train_step
from ..train.trainer import Trainer, TrainerConfig, noise_seed
from .common import build_dino_feature_fn, build_mask_dataset, feature_cond
from .sample import build_mask_sampler

__all__ = ["build_mask_dataset", "run", "main"]


def _reject_unported(cfg: dict) -> None:
    def bad(what: str):
        raise NotImplementedError(f"{what} is not ported to the PyTorch trainer yet")

    if cfg.get("remat"):
        bad("remat")
    if cfg.get("init_from"):
        bad("init_from")


def run(cfg: dict, exp: str = "exp", device=None) -> EMATrainState:
    """Train as the config says; returns the final train state."""
    device = resolve_device(cfg.get("device", device))
    configure_precision()
    _reject_unported(cfg)
    seed = int(cfg.get("seed", 0))
    num_classes = int(cfg.get("num_classes", 12))
    model = build_mask_sampler(cfg, device, cond_channels=1, seed=seed)
    n_params = sum(p.numel() for _, p in model.named_parameters())
    print(f"stage-1 UNet params: {n_params / 1e6:.2f}M")
    dataset, val_ds = build_mask_dataset(cfg, "train"), build_mask_dataset(cfg, "val")
    spatial = dataset.volume_shape
    loader = DataLoader(dataset, int(cfg.get("batch_size", 1)), seed=seed, device=device,
                        num_workers=int(cfg.get("mp_loaders", 2)))

    opt_cfg = cfg.get("optim", {})
    total_steps = int(cfg.get("max_steps", 100_000))
    optimizer = build_optimizer(
        model.named_parameters(),
        name=opt_cfg.get("name", "AdamW"),
        learning_rate=opt_cfg.get("learning_rate", 1e-3),
        lr_function=opt_cfg.get("lr_function"),
        lr_params=opt_cfg.get("lr_params"),
        total_steps=total_steps,
        grad_clip=opt_cfg.get("grad_clip"),
        accumulate_steps=int(opt_cfg.get("accumulate_steps", 1)),
        lr_restarts=opt_cfg.get("lr_restarts"),
        lr_restart_vals=opt_cfg.get("lr_restart_vals", 1.0),
    )
    state = EMATrainState(optimizer, ema_decay=float(cfg.get("polyak_alpha", 0.9999)))
    weights = cfg.get("class_weights", "uniform")
    class_weights = torch.as_tensor(np.ones(num_classes) if weights == "uniform" else weights,
                                    dtype=torch.float32, device=device)
    feat_fn, feat_idx, _ = build_dino_feature_fn(cfg, spatial, device)
    base_step = make_mask_train_step(model, class_weights, feature_inject_idx=feat_idx)
    if feat_fn is None:
        step_fn = base_step
    else:
        def step_fn(state: EMATrainState, batch: dict, noise: NoiseSource):
            return base_step(state, dict(batch, feature_cond=feat_fn(batch["image"])), noise)

    def eval_fn(state: EMATrainState, step: int, logger) -> float:
        n_eval = min(len(val_ds), int(cfg.get("n_validation_images", 2)))
        dices = []
        with state.ema_applied():
            for i in range(n_eval):
                item = val_ds[i]
                gt = torch.from_numpy(np.argmax(item["mask"], -1)).to(device)
                img = torch.from_numpy(item["image"])[None].to(device)
                ctx = torch.from_numpy(item["context"])[None].to(device) if "context" in item else None
                labels = model.sample_labels(NoiseSource(noise_seed(seed, step + i), device),
                                             (1, *spatial), cond=img, context=ctx,
                                             feature_cond=feature_cond(feat_fn, feat_idx, img),
                                             num_steps=int(cfg.get("eval_time_steps", 50)))
                dices.append(float(per_class_dice(labels[0], gt, num_classes)[1:].mean()))
        score = float(np.mean(dices))
        if logger:
            logger.scalars(step, {"dice": score}, prefix="val/")
        return score

    trainer = Trainer(
        TrainerConfig(
            logdir=f"{cfg.get('output_path', 'runs')}/{exp}",
            max_steps=total_steps,
            log_every=int(cfg.get("display_freq", 50)),
            save_every=int(cfg.get("save_freq", 1000)),
            eval_every=int(cfg.get("validation_freq_steps", 1000)),
            save_weights_every=cfg.get("save_weights_every"),
            profile_steps=int(cfg.get("profile_steps", 0) or 0),
            seed=seed,
        ),
        state, step_fn, loader, device,
        eval_fn=eval_fn if cfg.get("validate", True) else None,
        resume=bool(cfg.get("load_from")),
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
