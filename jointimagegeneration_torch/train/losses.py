"""Training losses for both stages, and the stage-1 timestep draw.

Counterpart of `jointimagegeneration_tpu/train/losses.py`:
  * stage 1 (categorical): per-voxel KL(theta_post(x_t, x0) ||
    theta_post_prob(x_t, x0_pred)) summed over classes and weighted by the
    true class's weight, plus unweighted CE on the x0 prediction; both summed
    and divided by the batch size;
  * stage 2 (Gaussian): l1 / l2 on eps (or x0), its per-example mean, with
    the optional learned logvar[t] scaling and the lvlb (elbo) term.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..diffusion.noise import NoiseSource

__all__ = ["sample_train_timesteps", "categorical_diffusion_loss", "gaussian_diffusion_loss"]

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


def gaussian_diffusion_loss(model_out: torch.Tensor, target: torch.Tensor, t: torch.Tensor,
                            lvlb_weights: torch.Tensor, loss_type: str = "l2",
                            logvar: Optional[torch.Tensor] = None, l_simple_weight: float = 1.0,
                            elbo_weight: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"loss", "loss_simple", "loss_vlb"}): the per-example mean error
    (B,), its batch mean, l_simple_weight x that mean (divided by exp(logvar[t])
    plus logvar[t] when a (T,) `logvar` is given) + elbo_weight x the
    lvlb_weights[t]-weighted mean."""
    if loss_type == "l2":
        err = (model_out - target) ** 2
    elif loss_type == "l1":
        err = (model_out - target).abs()
    else:
        raise ValueError(loss_type)
    per_ex = err.mean(dim=tuple(range(1, err.ndim)))
    loss_simple = per_ex.mean()
    if logvar is not None:
        lv = logvar[t]
        loss_gamma = (per_ex / torch.exp(lv) + lv).mean()
    else:
        loss_gamma = loss_simple
    loss_vlb = (lvlb_weights[t] * per_ex).mean()
    loss = l_simple_weight * loss_gamma + elbo_weight * loss_vlb
    return loss, {"loss": loss, "loss_simple": loss_simple, "loss_vlb": loss_vlb}
