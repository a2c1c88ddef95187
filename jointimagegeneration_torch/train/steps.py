"""The stage-1 train step.

Counterpart of `make_mask_train_step` in `jointimagegeneration_tpu/train/
steps.py`: t ~ t^1.5, x_t ~ q(x_t | x0), the UNet's x0 probabilities from
(x_t, t, cond = the batch's image), the KL + CE loss on the categorical
posterior, gradients of every parameter, then one optimizer + EMA update
(skipped if any gradient is not finite).  Random draws come from the
`NoiseSource` the caller hands in, in the JAX step's order: the (B, T)
timestep Gumbels, then the x_t Gumbels.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..diffusion.noise import NoiseSource
from ..models.mask_sampler import MaskSampler
from .losses import categorical_diffusion_loss, sample_train_timesteps
from .state import EMATrainState

__all__ = ["mask_loss", "make_mask_train_step"]


def mask_loss(model: MaskSampler, noise: NoiseSource, batch: Dict[str, torch.Tensor],
              class_weights: Optional[torch.Tensor] = None):
    """(loss, metrics) of one batch {"mask": one-hot x0 (B, D, H, W, C),
    "image": cond (B, D, H, W, 1)}."""
    if batch.get("context") is not None or batch.get("feature_cond") is not None:
        raise NotImplementedError("text context and feature conditioning are not ported to "
                                  "training yet")
    diff = model.diffusion
    x0 = batch["mask"]
    t = sample_train_timesteps(noise, x0.shape[0], diff.time_steps, device=x0.device)
    xt = diff.sample_q_xt_given_x0(noise, x0, t)
    x0pred = model.unet(xt, t.float(), cond=batch.get("image"))
    post_true = diff.theta_post(xt, x0, t)
    post_pred = diff.theta_post_prob(xt, x0pred, t)
    return categorical_diffusion_loss(post_true, post_pred, x0, x0pred, class_weights)


def make_mask_train_step(model: MaskSampler, class_weights: Optional[torch.Tensor] = None
                         ) -> Callable[[EMATrainState, dict, NoiseSource], Dict[str, torch.Tensor]]:
    """step(state, batch, noise) -> metrics {loss, loss_kl, loss_ce (detached
    tensors), grad_finite (1.0 or 0.0)}; updates `state` in place."""

    def step(state: EMATrainState, batch: dict, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        loss, metrics = mask_loss(model, noise, batch, class_weights)
        grads = torch.autograd.grad(loss, state.params)
        finite = state.apply_gradients(dict(zip(state.names, grads)))
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_finite"] = torch.tensor(float(finite))
        return out

    return step
