"""Diffusion noise schedules (pure NumPy, float64).

A copy of the parts of `jointimagegeneration_tpu/ops/schedules.py` that the
sampling path needs.  Two families that must not be conflated:

  * ccdm (stage-1, categorical): linear and cosine, the cosine taking
    cumalphas directly from cos^2 without renormalising by alphas[0];
  * LDM (stage-2, Gaussian): `gaussian_beta_schedule`, whose "linear" is
    linear in sqrt(beta).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

__all__ = [
    "ScheduleArrays",
    "make_categorical_schedule",
    "gaussian_beta_schedule",
    "ddim_timestep_subset",
    "ddim_sampling_parameters",
]


class ScheduleArrays(NamedTuple):
    """betas/alphas/cumalphas for T steps, float64 numpy."""

    betas: np.ndarray
    alphas: np.ndarray
    cumalphas: np.ndarray


def categorical_linear_schedule(time_steps: int, start: float = 1e-2, end: float = 0.2) -> ScheduleArrays:
    """Linear-in-beta schedule (ccdm diffusion_denoising.py:18-22)."""
    betas = np.linspace(start, end, time_steps, dtype=np.float64)
    alphas = 1.0 - betas
    return ScheduleArrays(betas, alphas, np.cumprod(alphas))


def categorical_cosine_schedule(time_steps: int, s: float = 8e-3) -> ScheduleArrays:
    """Cosine schedule, ccdm variant (diffusion_denoising.py:25-39).

    cumalphas is cos^2((t/T + s)/(1+s) * pi/2) at integer t in [0, T) with no
    alphas[0] renormalisation; betas come from the continuous ratio at
    (i, i+1)/T clipped to 0.999.  The reference overrides its own `s`
    argument with 0.008, and so does this copy."""
    s = 0.008
    t = np.arange(time_steps, dtype=np.float64)
    cumalphas = np.cos(((t / time_steps + s) / (1 + s)) * (math.pi / 2)) ** 2

    def f(u: float) -> float:
        return math.cos((u + s) / (1.0 + s) * math.pi / 2) ** 2

    betas = np.array(
        [min(1 - f((i + 1) / time_steps) / f(i / time_steps), 0.999) for i in range(time_steps)],
        dtype=np.float64,
    )
    return ScheduleArrays(betas, 1.0 - betas, cumalphas)


_CATEGORICAL_SCHEDULES = {
    "linear": categorical_linear_schedule,
    "cosine": categorical_cosine_schedule,
}


def make_categorical_schedule(name: str, time_steps: int, **params) -> ScheduleArrays:
    return _CATEGORICAL_SCHEDULES[name](time_steps, **params)


def gaussian_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule, LDM variant (ldm/modules/diffusionmodules/util.py:21-43)."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown gaussian beta schedule {schedule!r}")
    return betas


def ddim_timestep_subset(method: str, num_ddim: int, num_ddpm: int,
                         alphas_cumprod: np.ndarray | None = None) -> np.ndarray:
    """Indices of the DDPM steps visited by DDIM, with the reference's +1
    offset applied (values in [1, T]).  'uniform' and 'quad' mirror
    make_ddim_timesteps (util.py:46-60); 'uniform_lambda' spaces the subset
    uniformly in log-SNR and needs `alphas_cumprod`."""
    if num_ddim > num_ddpm:
        raise ValueError(f"ddim steps ({num_ddim}) cannot exceed ddpm timesteps ({num_ddpm})")
    if method == "uniform":
        c = num_ddpm // num_ddim
        steps = np.asarray(list(range(0, num_ddpm, c)))
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm * 0.8), num_ddim) ** 2).astype(int)
    elif method == "uniform_lambda":
        if alphas_cumprod is None:
            raise ValueError("uniform_lambda discretization needs alphas_cumprod")
        if num_ddim > num_ddpm - 1:
            raise ValueError(
                f"uniform_lambda supports at most {num_ddpm - 1} steps for "
                f"{num_ddpm} ddpm timesteps (got {num_ddim}); use 'uniform' "
                "for a full-length chain")
        ac = np.asarray(alphas_cumprod, np.float64)
        # candidates stop at T-2 so the +1 offset below stays in range
        lam = 0.5 * (np.log(ac[: num_ddpm - 1]) - np.log1p(-ac[: num_ddpm - 1]))
        grid = np.linspace(lam[-1], lam[0], num_ddim)
        steps = np.unique([int(np.abs(lam - g).argmin()) for g in grid])
        # argmin collisions can merge nodes: fill with the earliest unused steps
        missing = num_ddim - len(steps)
        if missing > 0:
            unused = np.setdiff1d(np.arange(num_ddpm - 1), steps)
            steps = np.sort(np.concatenate([steps, unused[:missing]]))
        if len(steps) != num_ddim:
            raise ValueError(f"uniform_lambda produced {len(steps)} steps, wanted {num_ddim}")
    else:
        raise ValueError(f"unknown ddim discretization {method!r}")
    return steps + 1


def ddim_sampling_parameters(alphas_cumprod: np.ndarray, ddim_timesteps: np.ndarray, eta: float):
    """(sigmas, alphas, alphas_prev) over the DDIM subset (util.py:63-74):
    alphas_prev[0] is alphas_cumprod[0], matching the +1-offset convention."""
    alphas = alphas_cumprod[ddim_timesteps]
    alphas_prev = np.concatenate([alphas_cumprod[:1], alphas_cumprod[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev
