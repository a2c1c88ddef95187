"""First-stage autoencoder training CLI: an AutoencoderKL (or VQModel) and a PatchGAN.

    python -m jointimagegeneration_torch.cli.train_ae <config.yml> <exp_name> [k=v ...] [device=cpu]

Counterpart of `jointimagegeneration_tpu/cli/train_ae.py`, reading the keys
of `configs/stage_ae.yml`: the AE from `model.embed_dim` / `model.ddconfig`
(`model.type: vq` trains the VQ model, `model.n_embed` codes), the
discriminator and the loss from `model.lossconfig` (`disc_ndf`,
`disc_num_layers`, `kl_weight`, `codebook_weight`, `disc_weight`,
`disc_start`, `pixel_loss`, `disc_loss`, `gan_feat_weight`), both Adam with
betas (0.5, 0.9) at lr = `base_learning_rate` x `batch_size`
(`train/gan.py`).  It trains on the slice dataset's `image` (`dataset.kind`
as `cli/common.build_slice_dataset` builds it) and writes under
`<output_path>/<exp_name>/`: every `display_freq` steps the metrics to
`metrics.jsonl` (`train/loss`, `d_loss`, `nll`, `kl` or `qloss`, `g_adv`,
`d_weight`, `imgs_per_sec`, `step_seconds`), every `save_freq` steps the
GAN state to `checkpoints/<step>.pt` (its `g_params` are what a latent
config's `first_stage.checkpoint` reads).  Runs on CUDA unless `device=cpu`
is given; `run(cfg, exp)` takes a config that is already a dict.

The AE trains on `batch["image"]` only, as the JAX trainer does.  A
`ddconfig.in_channels` that differs from the image's channels raises
ValueError before the first step: `configs/stage_ae.yml` sets 2 (the
[previous slice, mask] pair, the dataset's `cond`), which neither package
trains an AE on; `model.ddconfig.in_channels=1 model.ddconfig.out_ch=1`
trains the image AE.  Under torchrun each process trains on batch_size / N
rows and only rank 0 writes (`parallel/mesh.py`).  `init_from` warm-starts the
generator (`cli/common.maybe_init_from`: a `cli.train_ae` checkpoint's
`g_params`, a port `.pt`'s weights, or a JAX `.npz` of AE variables).  The VAE's `ddconfig.dropout` is inert here, as in the
JAX step, which runs its model deterministically.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.checkpoint import CheckpointManager
from ..core.config import load_yaml_config
from ..core.logging import MetricLogger, Throughput
from ..core.runtime import configure_precision, resolve_device, synchronize
from ..data.loader import DataLoader
from ..diffusion.noise import NoiseSource
from ..nn.discriminators import PatchDiscriminator
from ..parallel.mesh import (is_chief, local_batch_size, maybe_initialize_distributed, mean_over_ranks, rank_rows,
                             world_size)
from ..train.gan import GANTrainState, make_autoencoder_train_step, make_vq_train_step
from ..train.trainer import noise_seed
from ..utils.jax_weights import ae_state_dict_from_jax
from .common import build_autoencoder, build_slice_dataset, maybe_init_from

__all__ = ["run", "main"]


def check_image_channels(dataset, in_channels: int) -> None:
    """Raise ValueError unless the dataset's `image` has `in_channels`
    channels."""
    got = int(np.asarray(dataset[0]["image"]).shape[-1])
    if got != in_channels:
        raise ValueError(
            f"model.ddconfig.in_channels is {in_channels} but the dataset's 'image' has {got} channel(s): the AE "
            "trains on batch['image'] only; the 2-channel [previous slice, mask] pair is the dataset's 'cond', on "
            "which neither this trainer nor the JAX one trains an AE (set model.ddconfig.in_channels and out_ch to "
            f"{got} to train the image AE)")


def run(cfg: dict, exp: str = "exp", device=None) -> GANTrainState:
    """Train as the config says; returns the final GAN state."""
    device = maybe_initialize_distributed(resolve_device(cfg.get("device", device)))
    configure_precision()
    m = cfg.get("model", {})
    dd, loss_cfg = m.get("ddconfig", {}), m.get("lossconfig", {})
    seed = int(cfg.get("seed", 0))
    train_ds = build_slice_dataset(cfg, "train")
    check_image_channels(train_ds, int(dd.get("in_channels", 1)))
    model = build_autoencoder(m, device, seed=seed)
    disc = PatchDiscriminator(int(dd.get("in_channels", 1)), dims=int(dd.get("dims", 2)),
                              ndf=int(loss_cfg.get("disc_ndf", 64)), n_layers=int(loss_cfg.get("disc_num_layers", 3)),
                              device=device, seed=seed + 2)
    batch_size = int(cfg.get("batch_size", 1))
    lr = float(m.get("base_learning_rate", 4.5e-6)) * batch_size
    maybe_init_from(cfg, model.named_parameters(), bridge=ae_state_dict_from_jax)  # the generator, as JAX's
    state = GANTrainState.create(model, disc, lr)
    n_g, n_d = (sum(p.numel() for p in ps) for ps in (state.g_params, state.d_params))
    print(f"AE params: {n_g / 1e6:.2f}M, discriminator {n_d / 1e6:.2f}M, lr={lr:.2e}")
    loss_kw = dict(disc_weight=float(loss_cfg.get("disc_weight", 0.5)),
                   disc_start=int(loss_cfg.get("disc_start", 50001)),
                   pixel_loss=loss_cfg.get("pixel_loss", "l1"), disc_loss=loss_cfg.get("disc_loss", "hinge"))
    if m.get("type", "kl") == "vq":
        step_fn = make_vq_train_step(model, disc, codebook_weight=float(loss_cfg.get("codebook_weight", 1.0)),
                                     **loss_kw)
    else:
        step_fn = make_autoencoder_train_step(model, disc, kl_weight=float(loss_cfg.get("kl_weight", 1e-6)),
                                              feature_matching_weight=float(loss_cfg.get("gan_feat_weight", 0.0)),
                                              **loss_kw)

    loader = DataLoader(train_ds, local_batch_size(batch_size), seed=seed, device=device,
                        num_workers=int(cfg.get("num_workers", 2)))
    logdir = Path(cfg.get("output_path", "runs")) / exp
    chief = is_chief()  # only rank 0 writes, as the JAX CLI's logger
    logger = MetricLogger(logdir) if chief else None
    ckpt = CheckpointManager(logdir / "checkpoints") if chief else None
    tput = Throughput()
    max_steps = int(cfg.get("max_steps", 100_000))
    display, save = int(cfg.get("display_freq", 50)), int(cfg.get("save_freq", 1000))
    noise = rank_rows(NoiseSource(noise_seed(seed, 0), device))
    try:
        while state.step < max_steps:
            for batch in loader:
                if state.step >= max_steps:
                    break
                t0 = time.perf_counter()
                metrics = step_fn(state, {"image": batch["image"]}, noise)
                tput.update(batch["image"].shape[0] * world_size())
                if state.step % display == 0:
                    synchronize(device)
                    vals = mean_over_ranks(metrics, device)  # the global batch's, on every rank
                    vals["step_seconds"] = time.perf_counter() - t0
                    vals["imgs_per_sec"] = tput.rate()
                    if chief:
                        logger.scalars(state.step, vals, "train/")
                    tput.reset()
                if state.step % save == 0 and chief:
                    ckpt.save(state.step, state.state_dict())
    finally:
        if logger is not None:
            logger.close()
    return state


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    exp = argv[1] if len(argv) > 1 and "=" not in argv[1] else "exp"
    overrides = [a for a in argv[1:] if "=" in a]
    run(load_yaml_config(argv[0], overrides=overrides), exp)


if __name__ == "__main__":
    main()
