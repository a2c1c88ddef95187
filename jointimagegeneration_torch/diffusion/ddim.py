"""DDIM sampler parameters and single-step update.

Counterpart of `jointimagegeneration_tpu/diffusion/ddim.py`.  The subset
arrays are host float32 numpy (index 0 = the least noisy step); a step reads
its scalars from them and updates the sample tensor on its device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import schedules as _sched
from .gaussian import GaussianDiffusion
from .noise import NoiseSource

__all__ = ["DDIMParams", "ddim_step"]


@dataclass(frozen=True)
class DDIMParams:
    timesteps: np.ndarray  # (S,) int32, values in [1, T] (the +1 offset)
    alphas: np.ndarray  # (S,) float32, alpha-bar at each subset step
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray

    @classmethod
    def create(cls, diffusion: GaussianDiffusion, num_steps: int, method: str = "uniform",
               eta: float = 0.0) -> "DDIMParams":
        if num_steps >= diffusion.num_timesteps:
            raise ValueError(
                f"ddim subset needs num_steps < timesteps (got {num_steps} vs "
                f"{diffusion.num_timesteps}); a full-length chain is the ancestral sampler's")
        ac = np.asarray(diffusion.alphas_cumprod, np.float64)
        subset = _sched.ddim_timestep_subset(method, num_steps, diffusion.num_timesteps,
                                             alphas_cumprod=ac)
        if int(subset.max()) >= diffusion.num_timesteps:
            raise ValueError(
                f"ddim subset with method={method!r} and num_steps={num_steps} "
                f"reaches timestep {int(subset.max())} >= T={diffusion.num_timesteps} "
                "(the +1 subset-offset convention); choose num_steps <= T//2")
        sigmas, alphas, alphas_prev = _sched.ddim_sampling_parameters(ac, subset, eta)
        f32 = lambda x: np.asarray(x, np.float32)
        return cls(
            timesteps=np.asarray(subset, np.int32),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
            sigmas=f32(sigmas),
        )

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def ddim_step(params: DDIMParams, noise: NoiseSource, x: torch.Tensor, e_t: torch.Tensor,
              index: int, temperature: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One DDIM update x_t -> x_{t-1} from the eps prediction e_t at subset
    position `index`.  Returns (x_prev, pred_x0).  With sigma = 0 (eta = 0)
    the update is deterministic and draws no noise; otherwise the drawn noise
    is scaled by sigma, then by `temperature`."""
    a_prev = params.alphas_prev[index]
    sigma = params.sigmas[index]
    # scalar coefficients in float32, as the JAX package computes them
    pred_x0 = (x - float(params.sqrt_one_minus_alphas[index]) * e_t) / float(np.sqrt(params.alphas[index]))
    dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev - sigma * sigma, np.float32(0.0)))
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
    if sigma != 0:
        x_prev = x_prev + float(sigma) * noise.normal(x.shape).to(x.dtype) * temperature
    return x_prev, pred_x0
