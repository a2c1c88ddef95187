"""Gaussian DDPM schedule buffers for stage 2 (the part DDIM needs).

Counterpart of `jointimagegeneration_tpu/diffusion/gaussian.py`: betas and
alphas_cumprod from the LDM beta schedule, computed in float64 and stored in
float32 as the JAX package stores them (DDIM reads the float32 values).
"""

from __future__ import annotations

import numpy as np

from ..ops import schedules as _sched

__all__ = ["GaussianDiffusion"]


class GaussianDiffusion:
    def __init__(self, betas: np.ndarray, alphas_cumprod: np.ndarray):
        self.betas = betas
        self.alphas_cumprod = alphas_cumprod

    @classmethod
    def create(cls, beta_schedule: str = "linear", timesteps: int = 1000,
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3) -> "GaussianDiffusion":
        betas = _sched.gaussian_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                              linear_end=linear_end, cosine_s=cosine_s)
        ac = np.cumprod(1.0 - betas)
        return cls(betas.astype(np.float32), ac.astype(np.float32))

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]
