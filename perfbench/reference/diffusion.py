"""Plain fp32 samplers and their schedules, written from the published
algorithms, for judging the port: the LDM beta schedule and DDIM (Song et al.,
2021, as latent-diffusion's `DDIMSampler` runs it, eta 0), the ccdm cosine
schedule and the categorical posterior mixed over the predicted x0 (ccdm's
`diffusion_denoising.py`), the nearest-neighbour hand-off of labels to the CT
grid, and per-slice min-max normalisation.  Schedules are computed in float64
and used in fp32.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ldm_alphas_cumprod", "ddim_schedule", "ddim_update", "ccdm_schedule", "mask_t_values",
           "categorical_posterior", "upsample_nearest", "minmax", "one_hot"]


def ldm_alphas_cumprod(timesteps: int, linear_start: float, linear_end: float) -> np.ndarray:
    """latent-diffusion's 'linear' schedule: linear in sqrt(beta)."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def ddim_schedule(alphas_cumprod: np.ndarray, steps: int):
    """The 'uniform' DDIM subset with latent-diffusion's +1 offset: (timesteps,
    alphas, alphas_prev), index 0 the least noisy."""
    c = len(alphas_cumprod) // steps
    ts = np.arange(0, len(alphas_cumprod), c) + 1
    a = alphas_cumprod[ts]
    a_prev = np.concatenate([alphas_cumprod[:1], alphas_cumprod[ts[:-1]]])
    return ts, a, a_prev


def ddim_update(x: torch.Tensor, eps: torch.Tensor, a: float, a_prev: float) -> torch.Tensor:
    """x_{t-1} from x_t and the predicted noise, eta 0."""
    x0 = (x - math.sqrt(1.0 - a) * eps) / math.sqrt(a)
    return math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps


def ccdm_schedule(timesteps: int):
    """ccdm's cosine schedule: cumalphas = cos^2(((t/T + s)/(1 + s)) pi/2) at
    t in [0, T), no renormalisation; betas from the continuous ratio at
    (i, i + 1)/T, clipped at 0.999.  Returns (alphas, cumalphas)."""
    s = 0.008
    f = lambda u: np.cos((u + s) / (1.0 + s) * np.pi / 2) ** 2
    i = np.arange(timesteps, dtype=np.float64)
    betas = np.minimum(1.0 - f((i + 1) / timesteps) / f(i / timesteps), 0.999)
    return 1.0 - betas, f(i / timesteps)


def mask_t_values(timesteps: int, steps: int) -> np.ndarray:
    """The sampled t, descending from T to 1 over `steps` rounded points."""
    return np.round(np.linspace(timesteps, 1, steps)).astype(np.int64)


def categorical_posterior(xt: torch.Tensor, x0_probs: torch.Tensor, t: int, alphas, cumalphas) -> torch.Tensor:
    """sum over k of q(x_{t-1} | x_t, x0 = k) p(x0 = k), classes last, with
    q(x_{t-1} | x_t, x0) proportional to (a x_t + (1 - a)/C)(ca x0 + (1 - ca)/C),
    a = alphas[t - 1] and ca = cumalphas[t - 2]; at t = 1, a = 0 and ca = 1."""
    c = xt.shape[-1]
    a = 0.0 if t == 1 else float(alphas[t - 1])
    ca = 1.0 if t == 1 else float(cumalphas[t - 2])
    fwd = a * xt + (1.0 - a) / c
    out = torch.zeros_like(xt)
    for k in range(c):
        prior = torch.full((c,), (1.0 - ca) / c, dtype=xt.dtype, device=xt.device)
        prior[k] += ca
        theta = fwd * prior
        out += theta / theta.sum(dim=-1, keepdim=True) * x0_probs[..., k:k + 1]
    return out


def upsample_nearest(labels: torch.Tensor, shape) -> torch.Tensor:
    """(B, D, H, W) integer labels on the (D', H', W') grid: source index
    floor((i + 0.5) in / out) on each axis."""
    idx = [((torch.arange(o, device=labels.device) + 0.5) * (n / o)).floor().long()
           for n, o in zip(labels.shape[1:], shape)]
    return labels[:, idx[0]][:, :, idx[1]][:, :, :, idx[2]]


def minmax(s: torch.Tensor) -> torch.Tensor:
    """Per-slice min-max of (B, H, W, C) into [0, 1], eps 1e-8."""
    lo = s.amin(dim=(1, 2, 3), keepdim=True)
    hi = s.amax(dim=(1, 2, 3), keepdim=True)
    return (s - lo) / torch.clamp_min(hi - lo, 1e-8)


def one_hot(labels: torch.Tensor, c: int) -> torch.Tensor:
    return F.one_hot(labels.long(), c).float()
