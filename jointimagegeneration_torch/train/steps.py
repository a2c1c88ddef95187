"""The train steps of both stages.

Counterparts of `make_mask_train_step`, `make_ldm_train_step` and
`make_latent_ldm_train_step` in `jointimagegeneration_tpu/train/steps.py`.  Each computes its loss, the
gradients of every parameter the train state holds, then one optimizer + EMA
update (skipped if any gradient is not finite).  Random draws come from the
`NoiseSource` the caller hands in, in the JAX step's order:
  * stage 1: t ~ t^1.5 (the (B, T) timestep Gumbels), x_t ~ q(x_t | x0) (the
    x_t Gumbels), the text refiner over the batch's `context` with its
    dropout (the masks' uniforms; inside the loss, so the refiner's
    parameters get gradients), the UNet's x0 probabilities from (x_t, t,
    cond = the batch's image, the refined context, and with
    `feature_inject_idx` the batch's precomputed `feature_cond` map at that
    encoder site), the KL + CE loss on the categorical posterior;
  * stage 2: t ~ U[0, T) (randint), eps ~ N(0, 1) in the batch's dtype,
    x_noisy = q_sample(x0, t, eps), the UNet's output from (x_noisy, t, cond
    = the batch's [prev | mask], the batch's cross-attention `context`, the
    class ids `y` or `class_label` of 'adm' mode) against eps (or x0), the
    Gaussian loss with the model's learned logvar when it has one;
  * latent stage 2: the pixel batch through the frozen AEs first
    (`LatentSliceLDM.train_loss_inputs`: the image's posterior sample, one
    normal), then stage 2's draws on the latents (the JAX keys `ke, kl`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..diffusion.noise import NoiseSource
from ..models.mask_sampler import MaskSampler
from ..models.slice_ldm import SliceLDM
from .losses import categorical_diffusion_loss, gaussian_diffusion_loss, sample_train_timesteps
from .state import EMATrainState

__all__ = ["mask_loss", "make_mask_train_step", "ldm_loss", "make_ldm_train_step", "make_latent_ldm_train_step"]

TrainStep = Callable[[EMATrainState, dict, NoiseSource], Dict[str, torch.Tensor]]


def mask_loss(model: MaskSampler, noise: NoiseSource, batch: Dict[str, torch.Tensor],
              class_weights: Optional[torch.Tensor] = None, feature_inject_idx: Optional[int] = None):
    """(loss, metrics) of one batch {"mask": one-hot x0 (B, D, H, W, C),
    "image": cond (B, D, H, W, 1)}, optionally "context" (B, T, D) raw text
    features and, with `feature_inject_idx`, "feature_cond" (B, *spatial at
    that site, F) dense features computed before the step."""
    diff = model.diffusion
    x0 = batch["mask"]
    t = sample_train_timesteps(noise, x0.shape[0], diff.time_steps, device=x0.device)
    xt = diff.sample_q_xt_given_x0(noise, x0, t)
    context = model.refine_context(batch.get("context"), noise)
    fc = None if feature_inject_idx is None else {feature_inject_idx: batch["feature_cond"]}
    x0pred = model.unet(xt, t.float(), cond=batch.get("image"), context=context, feature_cond=fc)
    post_true = diff.theta_post(xt, x0, t)
    post_pred = diff.theta_post_prob(xt, x0pred, t)
    return categorical_diffusion_loss(post_true, post_pred, x0, x0pred, class_weights)


def _update(state: EMATrainState, loss: torch.Tensor, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    grads = torch.autograd.grad(loss, state.params)
    finite = state.apply_gradients(dict(zip(state.names, grads)))
    out = {k: v.detach() for k, v in metrics.items()}
    out["grad_finite"] = torch.tensor(float(finite))
    return out


def make_mask_train_step(model: MaskSampler, class_weights: Optional[torch.Tensor] = None,
                         feature_inject_idx: Optional[int] = None) -> TrainStep:
    """step(state, batch, noise) -> metrics {loss, loss_kl, loss_ce (detached
    tensors), grad_finite (1.0 or 0.0)}; updates `state` in place.  The
    state's parameters are `model.named_parameters()` (the UNet's, and the
    refiner's with one).  `feature_inject_idx` routes the batch's
    "feature_cond" map to that UNet encoder site."""

    def step(state: EMATrainState, batch: dict, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        return _update(state, *mask_loss(model, noise, batch, class_weights, feature_inject_idx))

    return step


def ldm_loss(model: SliceLDM, noise: NoiseSource, batch: Dict[str, torch.Tensor], loss_type: str = "l2",
             l_simple_weight: float = 1.0, elbo_weight: float = 0.0):
    """(loss, metrics) of one batch {"image": x0 (B, H, W, C), "cond": (B, H,
    W, cond_channels)}, with a cross-attention "context" and the class ids
    of 'adm' mode under "y" or "class_label" where the model takes them.
    The draws: t, then the noise (the JAX keys `kt, kn`)."""
    diff = model.diffusion
    x0 = batch["image"]
    t = noise.randint(0, diff.num_timesteps, (x0.shape[0],)).to(x0.device)
    eps = noise.normal(x0.shape).to(device=x0.device, dtype=x0.dtype)
    model_out = model.apply_model(diff.q_sample(x0, t, eps), t, cond=batch.get("cond"), context=batch.get("context"),
                                  y=batch.get("y", batch.get("class_label")))
    target = eps if diff.parameterization == "eps" else x0
    return gaussian_diffusion_loss(model_out, target, t, diff.buffer("lvlb_weights", x0.device), loss_type,
                                   logvar=model.logvar, l_simple_weight=l_simple_weight,
                                   elbo_weight=elbo_weight)


def make_ldm_train_step(model: SliceLDM, loss_type: str = "l2", l_simple_weight: float = 1.0,
                        elbo_weight: float = 0.0) -> TrainStep:
    """step(state, batch, noise) -> metrics {loss, loss_simple, loss_vlb
    (detached tensors), grad_finite (1.0 or 0.0)}; updates `state` in place.
    The state's parameters are `model.named_parameters()` (the UNet's, and
    `logvar` with learn_logvar)."""

    def step(state: EMATrainState, batch: dict, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        return _update(state, *ldm_loss(model, noise, batch, loss_type, l_simple_weight, elbo_weight))

    return step


def make_latent_ldm_train_step(latent_model, loss_type: str = "l2", l_simple_weight: float = 1.0,
                               elbo_weight: float = 0.0) -> TrainStep:
    """The latent (`_ae`) stage-2 step: batch["image"] and batch["cond"]
    through the frozen first and cond stages of `latent_model` (a
    `models.latent_ldm.LatentSliceLDM` that already carries its calibrated
    scale factor), then `make_ldm_train_step`'s step on the latents.  The AE
    weights take no gradient and are not in the train state."""
    inner = make_ldm_train_step(latent_model.inner, loss_type, l_simple_weight, elbo_weight)

    def step(state: EMATrainState, batch: dict, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        z0, cond_z = latent_model.train_loss_inputs(batch["image"], noise, batch.get("cond"))
        latent_batch = {**batch, "image": z0}
        if cond_z is not None:
            latent_batch["cond"] = cond_z
        return inner(state, latent_batch, noise)

    return step
