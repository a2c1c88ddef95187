"""Plain fp32 train steps of stage 2, written from the published loss, for
judging the port's first steps: latent-diffusion's `DDPM.p_losses` (eps
target, l2): t ~ U[0, T), eps ~ N(0, 1), x_t = sqrt(abar_t) x0 + sqrt(1 -
abar_t) eps, the mean squared error of the UNet's eps; AdamW (Loshchilov and
Hutter; PyTorch's and optax's form: decoupled decay lr x wd, bias-corrected
moments, eps outside the square root); and the EMA of the weights
(latent-diffusion's `LitEma`, whose decay ramps as min(decay, (1 + n) / (10 +
n)) at its n-th update, or ccdm's constant Polyak decay).  The draws replay
the program's (`draws.Replay`).  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import diffusion as rd
from .unet import unet_forward

__all__ = ["ldm_loss", "AdamW", "Ema", "leaf_norms", "relative_gaps"]


def ldm_loss(p, cfg, batch, replay, ops=None) -> torch.Tensor:
    x0 = batch["image"].float()
    ac = torch.tensor(rd.ldm_alphas_cumprod(cfg["timesteps"], cfg["linear_start"], cfg["linear_end"]),
                      dtype=torch.float32, device=x0.device)
    t = replay.randint(0, cfg["timesteps"], (x0.shape[0],))
    eps = replay.normal(x0.shape)
    a = ac[t].reshape(-1, *(1,) * (x0.ndim - 1))
    xt = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    out = unet_forward(p, cfg, xt, t.float(), batch["cond"].float(), ops=ops)
    return ((out - eps) ** 2).mean(dim=tuple(range(1, x0.ndim))).mean()


class AdamW:
    """AdamW over a dict of fp32 leaves; `step(grads, lr)`."""

    def __init__(self, params: Dict[str, torch.Tensor], betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.params, self.betas, self.eps, self.wd = params, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.n = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.n += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - lr * self.wd)
            denom = (self.v[k] / (1 - b2 ** self.n)).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.n))


class Ema:
    """`update(ema, params, i)` after the i-th optimizer step (from 0):
    ema <- ema - (1 - d) (ema - params), d = `decay`, or with `warmup`
    min(decay, (1 + n) / (10 + n)), n = i + 1 (LitEma's count of updates)."""

    def __init__(self, decay: float, warmup: bool):
        self.decay, self.warmup = decay, warmup

    def rate(self, i: int) -> float:
        n = i + 1
        return min(self.decay, (1.0 + n) / (10.0 + n)) if self.warmup else self.decay

    @torch.no_grad()
    def update(self, ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], i: int) -> None:
        d = self.rate(i)
        for k, e in ema.items():
            e.sub_((1.0 - d) * (e - params[k].detach().to(e.dtype)))


def leaf_norms(tensors: Dict[str, torch.Tensor], names: List[str]) -> List[float]:
    return [float(torch.linalg.vector_norm(tensors[n].float())) for n in names]


def relative_gaps(got: List[float], ref: List[float], keep: List[bool]) -> List[tuple]:
    """(|got - ref| over the larger of the leaf's reference norm and the
    median leaf's, leaf index) of every leaf kept, in ascending order."""
    kept = [r for r, k in zip(ref, keep) if k]
    median = sorted(kept)[len(kept) // 2] if kept else 0.0
    return sorted((abs(g - r) / max(r, median), i) for i, (g, r, k) in enumerate(zip(got, ref, keep))
                  if k and max(r, median) > 0)
