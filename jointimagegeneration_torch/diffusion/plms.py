"""PLMS (pseudo linear multistep) sampler.

Counterpart of `jointimagegeneration_tpu/diffusion/plms.py`, with a Python
loop and a list of the last three eps predictions.  The Adams-Bashforth order
ramps from the first executed step:
  step 0: Heun: x' from e_t, then e' = eps(x', t_prev), e_prime = (e_t + e') / 2
  step 1: (3 e_t - e_{t-1}) / 2
  step 2: (23 e_t - 16 e_{t-1} + 5 e_{t-2}) / 12
  step >= 3: (55 e_t - 59 e_{t-1} + 37 e_{t-2} - 9 e_{t-3}) / 24
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .ddim import DDIMParams

__all__ = ["plms_sample_loop"]


def _x_prev(ddim: DDIMParams, x: torch.Tensor, e: torch.Tensor, index: int) -> torch.Tensor:
    a_prev = ddim.alphas_prev[index]
    pred_x0 = (x - float(ddim.sqrt_one_minus_alphas[index]) * e) / float(np.sqrt(ddim.alphas[index]))
    return float(np.sqrt(a_prev)) * pred_x0 + float(np.sqrt(np.float32(1.0) - a_prev)) * e


def plms_sample_loop(eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], ddim: DDIMParams,
                     x_T: torch.Tensor, start_index: Optional[int] = None) -> torch.Tensor:
    """Run the chain from x_T; returns the x_0 estimate.  `eps_fn(x, t)` takes
    the (B,) int64 DDPM timesteps.  `start_index=k` (1 <= k <= num_steps)
    runs only the last k nodes from an x_T already at node k-1's noise level.
    The Heun step makes a second model call, so a chain of k nodes makes
    k + 1."""
    n = ddim.num_steps
    k_run = n if start_index is None else int(start_index)
    if not 1 <= k_run <= n:
        raise ValueError(f"start_index must be in [1, {n}], got {start_index}")

    def eps_at(x: torch.Tensor, index: int) -> torch.Tensor:
        t = torch.full((x.shape[0],), int(ddim.timesteps[index]), dtype=torch.int64, device=x.device)
        return eps_fn(x, t)

    x, hist = x_T, []  # hist[0] the most recent
    for step, index in enumerate(range(k_run - 1, -1, -1)):
        e_t = eps_at(x, index)
        if step == 0:
            e_prime = (e_t + eps_at(_x_prev(ddim, x, e_t, index), max(index - 1, 0))) / 2
        elif step == 1:
            e_prime = (3 * e_t - hist[0]) / 2
        elif step == 2:
            e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1] - 9 * hist[2]) / 24
        x = _x_prev(ddim, x, e_prime, index)
        hist = [e_t] + hist[:2]
    return x
