"""Categorical (discrete-state) diffusion over one-hot class volumes.

Counterpart of `jointimagegeneration_tpu/diffusion/categorical.py`: classes on
the trailing axis (B, *spatial, C), t in the reference's 1-based convention
[1, T], and the O(C) closed form of the x0-mixed posterior (see that module's
docstring for the derivation).  At t == 1 alphas[t-1] is taken as 0 and
cumalphas[t-2] as 1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import schedules as _sched
from .noise import NoiseSource

__all__ = ["CategoricalDiffusion", "sample_one_hot", "max_prob_one_hot"]


class CategoricalDiffusion:
    """Schedule constants (fp32 tensors on one device) + the posterior maps."""

    def __init__(self, betas: torch.Tensor, alphas: torch.Tensor, cumalphas: torch.Tensor,
                 num_classes: int):
        self.betas, self.alphas, self.cumalphas = betas, alphas, cumalphas
        self.num_classes = num_classes

    @classmethod
    def create(cls, schedule: str, time_steps: int, num_classes: int,
               device=None) -> "CategoricalDiffusion":
        arrs = _sched.make_categorical_schedule(schedule, time_steps)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        return cls(t(arrs.betas), t(arrs.alphas), t(arrs.cumalphas), num_classes)

    @property
    def time_steps(self) -> int:
        return self.betas.shape[0]

    def _gather_t(self, arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """arr[t - 1] shaped to broadcast against a rank-`ndim` tensor."""
        g = arr[t.long() - 1]
        return g.reshape(g.shape + (1,) * (ndim - 1))

    def q_xt_given_xtm1_probs(self, xtm1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Single-step forward kernel probs: (1 - beta_t) x_{t-1} + beta_t / C."""
        betas = self._gather_t(self.betas, t, xtm1.ndim)
        return (1.0 - betas) * xtm1 + betas / self.num_classes

    def q_xt_given_x0_probs(self, x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Marginal forward kernel probs: cumalpha_t x0 + (1 - cumalpha_t) / C."""
        ca = self._gather_t(self.cumalphas, t, x0.ndim)
        return ca * x0 + (1.0 - ca) / self.num_classes

    def sample_q_xt_given_x0(self, noise: NoiseSource, x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """One-hot x_t ~ q(x_t | x0), one Gumbel draw of x0's shape."""
        return sample_one_hot(noise, self.q_xt_given_x0_probs(x0, t))

    def _boundary_coeffs(self, t: torch.Tensor, ndim: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(alphas[t-1], cumalphas[t-2]) with the t == 1 overrides, shaped to
        broadcast against a rank-`ndim` tensor with batch leading."""
        idx = t.long() - 1
        is_t1 = idx == 0
        a = torch.where(is_t1, 0.0, self.alphas[idx])
        ca_prev = torch.where(is_t1, 1.0, self.cumalphas[idx - 1])  # idx-1 == -1 at t == 1
        shape = a.shape + (1,) * (ndim - 1)
        return a.reshape(shape), ca_prev.reshape(shape)

    def theta_post(self, xt: torch.Tensor, x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_{t-1} | x_t, x0) for one-hot x0."""
        a, ca_prev = self._boundary_coeffs(t, xt.ndim)
        c = self.num_classes
        theta = (a * xt + (1.0 - a) / c) * (ca_prev * x0 + (1.0 - ca_prev) / c)
        return theta / theta.sum(dim=-1, keepdim=True)

    def theta_post_prob(self, xt: torch.Tensor, theta_x0: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The posterior mixed over x0 ~ theta_x0, in closed form."""
        a, ca_prev = self._boundary_coeffs(t, xt.ndim)
        c = self.num_classes
        p = a * xt + (1.0 - a) / c
        p_sum = p.sum(dim=-1, keepdim=True)
        denom = ca_prev * p + (1.0 - ca_prev) / c * p_sum
        r = theta_x0 / denom
        return p * (ca_prev * r + (1.0 - ca_prev) / c * r.sum(dim=-1, keepdim=True))


def sample_one_hot(noise: NoiseSource, probs: torch.Tensor) -> torch.Tensor:
    """One-hot draw per position from trailing-axis probs:
    argmax(log(max(probs, 1e-12)) + Gumbel)."""
    logits = torch.log(probs.clamp_min(1e-12))
    idx = torch.argmax(logits + noise.gumbel(probs.shape).to(logits.dtype), dim=-1)
    return torch.nn.functional.one_hot(idx, probs.shape[-1]).to(probs.dtype)


def max_prob_one_hot(probs: torch.Tensor) -> torch.Tensor:
    """'majority' decode: argmax over classes."""
    idx = torch.argmax(probs, dim=-1)
    return torch.nn.functional.one_hot(idx, probs.shape[-1]).to(probs.dtype)
