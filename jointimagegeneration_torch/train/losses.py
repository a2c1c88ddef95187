"""Stage-1 training loss and timestep draw.

Counterpart of `jointimagegeneration_tpu/train/losses.py` (the categorical
part; the Gaussian loss comes with stage-2 training): per-voxel KL(theta_post
(x_t, x0) || theta_post_prob(x_t, x0_pred)) summed over classes and weighted
by the true class's weight, plus unweighted CE on the x0 prediction; both
summed and divided by the batch size.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..diffusion.noise import NoiseSource

__all__ = ["sample_train_timesteps", "categorical_diffusion_loss"]

_EPS = 1e-12


def sample_train_timesteps(noise: NoiseSource, batch: int, time_steps: int,
                           device=None) -> torch.Tensor:
    """t ~ p(t) proportional to t^1.5 over [1, T], as 1 + argmax(1.5 log(1..T)
    + Gumbel) with one (batch, T) Gumbel draw (jax.random.categorical's form)."""
    logits = 1.5 * torch.log(torch.arange(1, time_steps + 1, dtype=torch.float32, device=device))
    return 1 + torch.argmax(logits + noise.gumbel((batch, time_steps)).to(logits.device), dim=-1)


def categorical_diffusion_loss(theta_post_true: torch.Tensor, theta_post_pred: torch.Tensor,
                               x0: torch.Tensor, x0_pred_probs: torch.Tensor,
                               class_weights: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "loss_kl", "loss_ce"}); every tensor (B, ..., C) with the
    classes last, x0 one-hot, class_weights (C,)."""
    b = x0.shape[0]
    log_pred = torch.log(theta_post_pred.clamp_min(_EPS))
    kl = (theta_post_true * (torch.log(theta_post_true.clamp_min(_EPS)) - log_pred)).sum(dim=-1)
    if class_weights is not None:
        kl = kl * class_weights[torch.argmax(x0, dim=-1)]
    ce = -(x0 * torch.log(x0_pred_probs.clamp_min(_EPS))).sum(dim=-1)
    loss_kl = kl.sum() / b
    loss_ce = ce.sum() / b
    loss = loss_kl + loss_ce
    return loss, {"loss": loss, "loss_kl": loss_kl, "loss_ce": loss_ce}
