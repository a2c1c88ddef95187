"""VAE + GAN training with two optimizers (the `_ae` config's first stage).

Counterpart of `jointimagegeneration_tpu/train/gan.py`, the JAX package's
re-derivation of the reference's LPIPSWithDiscriminator
(`ldm/modules/losses/contperceptual.py:49-293`):

  generator loss = nll + kl_weight * KL + d_weight * disc_factor * (-mean D(rec))
      nll = the L1 (or L2) reconstruction error summed, over the batch, plus feature_matching_weight * sum of mean |D_l(rec) -
      D_l(x)| over the discriminator's layers (real features detached);
  discriminator loss = disc_factor * hinge (or vanilla) on (D(x), D(rec));
  d_weight = ||d nll / d W|| / (||d adv / d W|| + 1e-4), clipped to [0, 1e4]
      and scaled by disc_weight, W the decoder's `conv_out` weight, nll the
      pixel term without feature matching (as the JAX `heads` computes it);
      computed from `disc_start` on, 0 before;
  disc_factor = 0 before `disc_start` steps, 1 from there.

One step updates the generator first, against the discriminator as it was,
then the discriminator on the detached reconstruction of that generator
forward.  Both gradients of the adaptive weight are taken on the generator
forward's own graph (`torch.autograd.grad(..., retain_graph=True)`), where the
JAX step re-runs the forward inside `heads`; the value is the same.  Before
`disc_start` the discriminator's loss is 0 times a finite value, so its
forward is skipped and its Adam step takes zero gradients, which leave its
parameters as they are and count the step, as the JAX step's update does.

Under data parallelism (`parallel/mesh.py`) both updates and the adaptive
weight's two gradients are averaged over the ranks first, so the weight is
the global batch's, as under the JAX step's psum.

The KL step draws one normal of the posterior's shape from the `NoiseSource`
(the JAX step's `k_sample`); the VQ step draws nothing.  The JAX steps'
`perceptual_fn` and `adaptive_d_weight=False`, which no caller there sets, are
left out: the weight is always adaptive, the nll pixel-only.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.noise import NoiseSource
from ..parallel.mesh import average_gradients
from .optim import Optimizer, build_optimizer

__all__ = ["GANTrainState", "make_autoencoder_train_step", "make_vq_train_step", "hinge_d_loss", "vanilla_d_loss",
           "adaptive_d_weight"]

GANStep = Callable[["GANTrainState", dict, NoiseSource], Dict[str, torch.Tensor]]


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


class GANTrainState:
    """The generator and the discriminator with their optimizers and the
    step count.  The parameters are updated in place; `state_dict` holds
    `g_params` (the generator's weights by name, which `cli.common.
    load_ae_weights` reads), `d_params`, both optimizers' states and `step`."""

    def __init__(self, g_opt: Optimizer, d_opt: Optimizer):
        self.g_opt, self.d_opt = g_opt, d_opt
        self.step = 0

    @classmethod
    def create(cls, generator: nn.Module, discriminator: nn.Module, learning_rate: float) -> "GANTrainState":
        """Adam with betas (0.5, 0.9) for each, as the JAX CLI builds them."""
        return cls(build_optimizer(list(generator.named_parameters()), "Adam", learning_rate, betas=(0.5, 0.9)),
                   build_optimizer(list(discriminator.named_parameters()), "Adam", learning_rate, betas=(0.5, 0.9)))

    @property
    def g_params(self) -> List[torch.Tensor]:
        return [p for _, p in self.g_opt.named_params]

    @property
    def d_params(self) -> List[torch.Tensor]:
        return [p for _, p in self.d_opt.named_params]

    def state_dict(self) -> Dict:
        return {"step": self.step,
                "g_params": {n: p.detach() for n, p in self.g_opt.named_params},
                "d_params": {n: p.detach() for n, p in self.d_opt.named_params},
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        with torch.no_grad():
            for key, opt in (("g_params", self.g_opt), ("d_params", self.d_opt)):
                for n, p in opt.named_params:
                    p.copy_(sd[key][n])
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        self.step = int(sd["step"])


def adaptive_d_weight(nll: torch.Tensor, g_adv: torch.Tensor, last_layer: torch.Tensor,
                      disc_weight: float) -> torch.Tensor:
    """||d nll / d last_layer|| / (||d g_adv / d last_layer|| + 1e-4), clipped
    to [0, 1e4], times disc_weight; detached.  Both gradients come from the
    graph the losses were computed on, which stays for the generator's own
    backward."""
    nll_g, = torch.autograd.grad(nll, last_layer, retain_graph=True)
    adv_g, = torch.autograd.grad(g_adv, last_layer, retain_graph=True)
    average_gradients([nll_g, adv_g])  # the global batch's gradients under data parallelism
    ratio = torch.linalg.vector_norm(nll_g) / (torch.linalg.vector_norm(adv_g) + 1e-4)
    return (torch.clamp(ratio, 0.0, 1e4) * disc_weight).detach()


def _pixel_nll(x: torch.Tensor, rec: torch.Tensor, pixel_loss: str) -> torch.Tensor:
    err = (x - rec).abs() if pixel_loss == "l1" else (x - rec) ** 2
    return err.sum() / x.shape[0]


def _gan_update(state: GANTrainState, discriminator: nn.Module, x: torch.Tensor, loss: torch.Tensor,
                rec: torch.Tensor, disc_factor: float, d_loss_fn) -> torch.Tensor:
    """The generator's Adam step on `loss`, then the discriminator's on the
    detached `rec`; returns the discriminator's loss."""
    grads = torch.autograd.grad(loss, state.g_params, allow_unused=True)
    average_gradients(grads)
    state.g_opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(state.g_params, grads)])
    rec = rec.detach()
    if disc_factor:
        d_loss = disc_factor * d_loss_fn(discriminator(x), discriminator(rec))
        d_grads = torch.autograd.grad(d_loss, state.d_params)
        average_gradients(d_grads)
    else:  # 0 x the loss: zero gradients, and Adam still counts the step
        d_loss = torch.zeros((), device=x.device)
        d_grads = [torch.zeros_like(p) for p in state.d_params]
    state.d_opt.step(d_grads)
    state.step += 1
    return d_loss.detach()


def _weight(on: bool, nll, g_adv, model, disc_weight: float) -> torch.Tensor:
    if not on:  # the ratio is multiplied by disc_factor = 0 before disc_start
        return torch.zeros((), device=nll.device)
    return adaptive_d_weight(nll, g_adv, model.decoder.conv_out.weight, disc_weight)


def make_autoencoder_train_step(model: nn.Module, discriminator: nn.Module, kl_weight: float = 1e-6,
                                disc_weight: float = 0.5, disc_start: int = 50001, pixel_loss: str = "l1",
                                disc_loss: str = "hinge", feature_matching_weight: float = 0.0) -> GANStep:
    """step(state, batch, noise) -> metrics {loss, d_loss, nll, kl, g_adv,
    d_weight} (detached) for an AutoencoderKL on batch["image"]; updates
    `state` in place."""
    d_loss_fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss

    def step(state: GANTrainState, batch: dict, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        x = batch["image"]
        on = state.step >= disc_start
        disc_factor = 1.0 if on else 0.0
        rec, posterior = model(x, noise)
        nll = _pixel_nll(x, rec, pixel_loss)
        kl = posterior.kl().sum() / x.shape[0]
        if feature_matching_weight > 0:
            logits_fake, feats_fake = discriminator(rec, return_features=True)
            with torch.no_grad():
                _, feats_real = discriminator(x, return_features=True)
            fm = sum((a - b).abs().mean() for a, b in zip(feats_fake, feats_real))
        else:
            logits_fake, fm = discriminator(rec), None
        g_adv = -logits_fake.mean()
        d_weight = _weight(on, nll, g_adv, model, disc_weight)
        total_nll = nll if fm is None else nll + feature_matching_weight * fm
        loss = total_nll + kl_weight * kl + d_weight * disc_factor * g_adv
        d_loss = _gan_update(state, discriminator, x, loss, rec, disc_factor, d_loss_fn)
        return {"loss": loss.detach(), "d_loss": d_loss, "nll": total_nll.detach(), "kl": kl.detach(),
                "g_adv": g_adv.detach(), "d_weight": d_weight}

    return step


def make_vq_train_step(model: nn.Module, discriminator: nn.Module, codebook_weight: float = 1.0,
                       disc_weight: float = 0.5, disc_start: int = 50001, pixel_loss: str = "l1",
                       disc_loss: str = "hinge") -> GANStep:
    """The VQGAN step: reconstruction + codebook_weight * the quantizer's
    loss + the adversarial term with the same adaptive weight; metrics
    {loss, d_loss, nll, qloss, g_adv, d_weight}.  Draws nothing."""
    d_loss_fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss

    def step(state: GANTrainState, batch: dict, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        x = batch["image"]
        on = state.step >= disc_start
        disc_factor = 1.0 if on else 0.0
        rec, qloss, _ = model(x)
        nll = _pixel_nll(x, rec, pixel_loss)
        g_adv = -discriminator(rec).mean()
        d_weight = _weight(on, nll, g_adv, model, disc_weight)
        loss = nll + codebook_weight * qloss + d_weight * disc_factor * g_adv
        d_loss = _gan_update(state, discriminator, x, loss, rec, disc_factor, d_loss_fn)
        return {"loss": loss.detach(), "d_loss": d_loss, "nll": nll.detach(), "qloss": qloss.detach(),
                "g_adv": g_adv.detach(), "d_weight": d_weight}

    return step
