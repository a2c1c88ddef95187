"""DPM-Solver++(2M): the second-order multistep ODE sampler.

Counterpart of `jointimagegeneration_tpu/diffusion/dpm_solver.py`, with a
Python loop over the nodes.  With alpha = sqrt(abar), sigma = sqrt(1 - abar)
and lambda = log(alpha / sigma) at each node (fp32), and
D_i = (x - sigma_i eps(x, t_i)) / alpha_i:

  h_i   = lambda_{i+1} - lambda_i,   r_i = h_{i-1} / h_i
  Dbar  = (1 + 1/(2 r_i)) D_i - 1/(2 r_i) D_{i-1}      (first executed step: D_i)
  x_{i+1} = (sigma_{i+1} / sigma_i) x - alpha_{i+1} expm1(-h_i) Dbar

The nodes are DDIMParams' subset: abar runs down alphas[n-1..0] and the
chain ends at alphas_prev[0], as the DDIM loop does.  The scalars are numpy
float32, the sample a tensor on its device.  Each node is a `sampler.step`
span (`core.logging.span`, with card events).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.logging import span
from .ddim import DDIMParams

__all__ = ["dpm_solver_sample_loop"]

_ONE = np.float32(1.0)


def _node(a: np.float32):
    alpha, sigma = np.sqrt(a), np.sqrt(_ONE - a)
    return alpha, sigma, np.log(alpha) - np.log(sigma)


def dpm_solver_sample_loop(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], ddim: DDIMParams,
                           x_T: torch.Tensor, start_index: Optional[int] = None) -> torch.Tensor:
    """Run the chain from x_T; returns the final x.  `eps_fn(x, t)` takes the
    (B,) int64 DDPM timesteps.  `start_index=k` (1 <= k <= num_steps) runs
    only the last k nodes (subset indices k-1 ... 0) from an x_T already at
    node k-1's noise level; the first executed step is first order either
    way."""
    n = ddim.num_steps
    k_run = n if start_index is None else int(start_index)
    if not 1 <= k_run <= n:
        raise ValueError(f"start_index must be in [1, {n}], got {start_index}")
    abar = np.asarray(ddim.alphas, np.float32)
    abar_prev = np.asarray(ddim.alphas_prev, np.float32)
    x, d_prev, lam_prev = x_T, None, None
    for index in range(k_run - 1, -1, -1):
        alpha_c, sigma_c, lam_c = _node(abar[index])
        alpha_n, sigma_n, lam_n = _node(abar_prev[index])
        with span("sampler.step", True):
            t = torch.full((x.shape[0],), int(ddim.timesteps[index]), dtype=torch.int64, device=x.device)
            d = (x - float(sigma_c) * eps_fn(x, t)) / float(alpha_c)
            h = lam_n - lam_c
            if d_prev is None:
                d_bar = d
            else:
                c = _ONE / (np.float32(2.0) * ((lam_c - lam_prev) / h))
                d_bar = float(_ONE + c) * d - float(c) * d_prev
            x = float(sigma_n / sigma_c) * x - float(alpha_n * np.expm1(-h)) * d_bar
        d_prev, lam_prev = d, lam_c
    return x
