"""Gaussian DDPM process for stage 2: the schedule buffers and the q / p maps.

Counterpart of `jointimagegeneration_tpu/diffusion/gaussian.py`: every buffer
is computed in float64 numpy from the LDM beta schedule and stored in float32
as the JAX package stores it (DDIM reads the float32 alphas_cumprod).  The
maps take channels-last tensors (B, *spatial, C) and 0-based integer t (B,);
each reads its buffers as float32 tensors on t's device.  `p_sample` draws
its noise from a `NoiseSource`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import schedules as _sched
from .noise import NoiseSource

__all__ = ["GaussianDiffusion"]

class GaussianDiffusion:
    """The buffers are float32 numpy arrays of length T under the JAX names;
    `create` builds them."""

    def __init__(self, parameterization: str = "eps"):
        self.parameterization = parameterization
        self._on = {}  # (name, device) -> tensor

    @classmethod
    def create(cls, beta_schedule: str = "linear", timesteps: int = 1000, linear_start: float = 1e-4,
               linear_end: float = 2e-2, cosine_s: float = 8e-3,
               parameterization: str = "eps") -> "GaussianDiffusion":
        betas = _sched.gaussian_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                              linear_end=linear_end, cosine_s=cosine_s)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        if parameterization == "eps":
            with np.errstate(divide="ignore"):  # post_var[0] == 0: lvlb[0] is inf, overwritten below
                lvlb = betas**2 / (2 * post_var * alphas * (1 - ac))
        elif parameterization == "x0":
            lvlb = 0.5 * np.sqrt(ac) / (2.0 * 1 - ac)  # the reference's literal expression, as in JAX
        else:
            raise NotImplementedError(parameterization)
        lvlb[0] = lvlb[1]
        d = cls(parameterization)
        for name, arr in dict(
            betas=betas,
            alphas_cumprod=ac,
            alphas_cumprod_prev=ac_prev,
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1),
            posterior_variance=post_var,
            posterior_log_variance_clipped=np.log(np.maximum(post_var, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
            posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
            lvlb_weights=lvlb,
        ).items():
            setattr(d, name, np.asarray(arr, np.float32))
        return d

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def buffer(self, name: str, device) -> torch.Tensor:
        """The float32 buffer `name` as a tensor on `device` (made once)."""
        key = (name, torch.device(device))
        if key not in self._on:
            self._on[key] = torch.from_numpy(getattr(self, name)).to(device)
        return self._on[key]

    def _at(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        g = self.buffer(name, t.device)[t.long()]
        return g.reshape(g.shape + (1,) * (ndim - 1))

    # -- forward ---------------------------------------------------------------

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(alphā_t) x0 + sqrt(1 - alphā_t) eps."""
        return (self._at("sqrt_alphas_cumprod", t, x_start.ndim) * x_start
                + self._at("sqrt_one_minus_alphas_cumprod", t, x_start.ndim) * noise)

    # -- reverse ---------------------------------------------------------------

    def predict_start_from_noise(self, x_t: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return (self._at("sqrt_recip_alphas_cumprod", t, x_t.ndim) * x_t
                - self._at("sqrt_recipm1_alphas_cumprod", t, x_t.ndim) * noise)

    def q_posterior(self, x_start: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, variance, clipped log-variance) of q(x_{t-1} | x_t, x0)."""
        mean = (self._at("posterior_mean_coef1", t, x_t.ndim) * x_start
                + self._at("posterior_mean_coef2", t, x_t.ndim) * x_t)
        return (mean, self._at("posterior_variance", t, x_t.ndim),
                self._at("posterior_log_variance_clipped", t, x_t.ndim))

    def predict_x0(self, model_out: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                   clip_denoised: bool = True) -> torch.Tensor:
        """The x0 estimate from the model output at (x, t) under the configured
        parameterization."""
        x_recon = self.predict_start_from_noise(x, t, model_out) if self.parameterization == "eps" else model_out
        return x_recon.clamp(-1.0, 1.0) if clip_denoised else x_recon

    def p_mean_variance(self, model_out: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                        clip_denoised: bool = True):
        return self.q_posterior(self.predict_x0(model_out, x, t, clip_denoised), x, t)

    def p_sample(self, noise: NoiseSource, model_out: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                 clip_denoised: bool = True) -> torch.Tensor:
        """One ancestral step given the model output at (x, t): one normal draw
        of x's shape, not added where t == 0."""
        mean, _, log_var = self.p_mean_variance(model_out, x, t, clip_denoised)
        eps = noise.normal(x.shape).to(device=x.device, dtype=x.dtype)
        nonzero = (t > 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        return mean + nonzero * torch.exp(0.5 * log_var) * eps
