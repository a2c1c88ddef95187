"""Train state: the optimizer's parameters, an fp32 EMA copy, the optimizer.

Counterpart of `jointimagegeneration_tpu/train/state.py`.  The EMA is the
ccdm Polyak average (ema = decay * ema + (1 - decay) * params) or, with
`ema_warmup`, the LDM LitEma ramp min(decay, (1 + n) / (10 + n)) at step n.
An update whose gradients are not all finite is skipped: params, optimizer
state (and so its count) and EMA stay as they were, while `step` and
`nonfinite_count` advance (optax.apply_if_finite's semantics), so a debug
checkpoint taken after a NaN is the last good state.

Under gradient accumulation (the optimizer's `accumulate_steps` > 1) every
call is a micro-step, as in the JAX state: `step` advances on each, the EMA
moves toward the params on each finite one (which change only on every k-th),
and a non-finite one leaves the accumulated gradients as they were.

The parameters (the module's, as the optimizer holds them) are updated in
place; the EMA tensors are separate fp32 tensors on their device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping

import torch

from .optim import Optimizer

__all__ = ["EMATrainState"]


class EMATrainState:
    def __init__(self, optimizer: Optimizer, ema_decay: float = 0.9999, ema_warmup: bool = False):
        self.optimizer = optimizer
        self.names = [n for n, _ in optimizer.named_params]
        self.params = [p for _, p in optimizer.named_params]
        with torch.no_grad():
            self.ema = [p.detach().float().clone() for p in self.params]
        self.ema_decay = ema_decay
        self.ema_warmup = ema_warmup
        self.step = 0
        self.nonfinite_count = 0

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> bool:
        """One optimizer update and EMA update from {param name: gradient}.
        Returns whether every gradient was finite (if not, nothing but `step`
        and `nonfinite_count` changes)."""
        gs = [grads[n] for n in self.names]
        finite = bool(torch.stack([torch.isfinite(g).all() for g in gs]).all())
        step = self.step
        self.step += 1
        if not finite:
            self.nonfinite_count += 1
            return False
        self.optimizer.step(gs)
        decay = self.ema_decay
        if self.ema_warmup:
            n = step + 1.0
            decay = min(decay, (1.0 + n) / (10.0 + n))
        with torch.no_grad():
            torch._foreach_mul_(self.ema, decay)
            torch._foreach_add_(self.ema, [p.detach().float() for p in self.params], alpha=1.0 - decay)
        return True

    def _swap_ema(self) -> None:
        for p, e in zip(self.params, self.ema):
            p.data, e.data = e.data, p.data  # exchange storage, no copy

    @contextlib.contextmanager
    def ema_applied(self) -> Iterator[None]:
        """Run the module with the EMA weights (as the JAX trainer samples
        from `ema_params`); the training weights come back on exit."""
        self._swap_ema()
        try:
            yield
        finally:
            self._swap_ema()

    def state_dict(self) -> Dict:
        """{params, ema (name -> tensor), optimizer, step, nonfinite_count}."""
        return {"params": {n: p.detach() for n, p in zip(self.names, self.params)},
                "ema": dict(zip(self.names, self.ema)),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "nonfinite_count": self.nonfinite_count}

    def load_state_dict(self, sd: Mapping) -> None:
        with torch.no_grad():
            for n, p, e in zip(self.names, self.params, self.ema):
                p.copy_(sd["params"][n])
                e.copy_(sd["ema"][n])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
        self.nonfinite_count = int(sd["nonfinite_count"])
