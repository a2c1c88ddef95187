"""Optimizers and LR schedules with optax's semantics.

Counterpart of `jointimagegeneration_tpu/train/optim.py`.  The schedules are
the same pure step -> lr functions (every `lr_function` it knows, restarts
included), here in Python floats.  The optimizers are torch's, wrapped so they
behave as the JAX package's optax chains do:
  * SGD: weight decay 5e-4 added to the gradient, then momentum 0.9
    (`add_decayed_weights` then `sgd`; torch's SGD with `weight_decay` is the
    same update);
  * Adam: optax.adam (eps 1e-8, eps_root 0);
  * AdamW: optax.adamw, weight decay 0.01 scaled by the lr (torch's AdamW);
  * `grad_clip`: optax.clip_by_global_norm, which scales by max_norm / norm
    only when norm >= max_norm (torch's clip_grad_norm_ adds 1e-6 and differs);
  * the schedule reads the optimizer's own count of applied updates, as
    optax's scale_by_schedule does: a step skipped for non-finite gradients
    (train/state.py) advances neither the count nor the lr;
  * `accumulate_steps` k > 1: optax.MultiSteps (mean over k micro-steps) —
    each call folds its gradients into a running mean (acc += (g - acc) /
    (n + 1), n the micro-step), and every k-th call hands the mean to the
    clip and the update above and zeroes it; the other calls change no
    parameter, and the count advances on applied updates only.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["build_lr_schedule", "build_optimizer", "clip_by_global_norm", "Optimizer"]

Schedule = Callable[[int], float]


def _restart_schedule(lr_function: str, base_lr: float, total_steps: int, p: dict,
                      lr_restarts: Sequence[int], lr_restart_vals) -> Schedule:
    """The step range split at `lr_restarts` into segments; segment i starts
    from a base multiplier (restart_vals**i for a scalar, or [1, *list]) and
    runs the shape function over (steps since restart, steps in segment)."""
    bounds = [0] + sorted(int(r) for r in lr_restarts) + [int(total_steps)]
    n_seg = len(bounds) - 1
    if isinstance(lr_restart_vals, (int, float)):
        seg_vals = [float(lr_restart_vals) ** i for i in range(n_seg)]
    else:
        if len(lr_restart_vals) != n_seg - 1:
            raise ValueError("lr_restart_vals list must have len(lr_restarts) entries")
        seg_vals = [1.0] + [float(v) for v in lr_restart_vals]
    starts, ends = bounds[:-1], bounds[1:]
    power, min_lr, gamma = p.get("power", 1.0), p.get("min_lr", 0.0), p.get("gamma", 0.98)
    if lr_function not in ("static", "exponential", "polynomial", "cosine"):
        raise ValueError(f"lr_function {lr_function!r} does not support restarts")

    def sched(step: int) -> float:
        seg = min(max(bisect.bisect_right(starts, step) - 1, 0), n_seg - 1)
        since, length = float(step - starts[seg]), float(ends[seg] - starts[seg])
        if lr_function == "static":
            shape = 1.0
        elif lr_function == "exponential":
            shape = gamma ** since
        elif lr_function == "polynomial":
            coeff = (1.0 - min(since, length - 1) / max(length - 1.0, 1.0)) ** power
            shape = (1.0 - min_lr / base_lr) * coeff + min_lr / base_lr
        else:  # cosine
            shape = 0.5 * (1.0 + math.cos(math.pi * min(since, length) / length))
        return base_lr * seg_vals[seg] * shape

    return sched


def _cyclic_schedule(lr_function: str, base_lr: float, total_steps: int, p: dict) -> Schedule:
    """LDM warmup-cosine2 / warmup-linear: repeated cycles, each with its own
    warmup, f_start / f_max / f_min and length; f multiplies base_lr.  A step
    landing exactly on a cycle's cumulative end belongs to that cycle."""
    def as_list(key, default):
        v = p.get(key, default)
        return [float(x) for x in (v if isinstance(v, (list, tuple)) else [v])]

    lengths = as_list("cycle_lengths", [total_steps])
    ncyc = len(lengths)

    def per_cycle(key, default):
        v = as_list(key, default)
        v = v * ncyc if len(v) == 1 else v
        if len(v) != ncyc:
            raise ValueError(f"lr_params[{key!r}] needs one entry per cycle ({ncyc})")
        return v

    warm, f_min = per_cycle("warm_up_steps", [0.0]), per_cycle("f_min", [0.0])
    f_max, f_start = per_cycle("f_max", [1.0]), per_cycle("f_start", [0.0])
    imax = 2**31 - 1  # cycle bounds past int32 are unreachable step counts, as in the JAX package
    cum = [0]
    for c in lengths:
        cum.append(min(cum[-1] + int(c), imax))
    starts, uppers = cum[:-1], cum[1:]
    cosine = lr_function == "warmup-cosine2"

    def sched(step: int) -> float:
        c = min(max(bisect.bisect_left(uppers, step), 0), ncyc - 1)
        n, w = float(step - starts[c]), warm[c]
        if n < w:
            return base_lr * (f_start[c] + (f_max[c] - f_start[c]) / max(w, 1.0) * n)
        if cosine:
            t = min((n - w) / max(lengths[c] - w, 1.0), 1.0)
            f = f_min[c] + 0.5 * (f_max[c] - f_min[c]) * (1.0 + math.cos(t * math.pi))
        else:  # past the final cycle the linear ramp is clamped at f_min
            f = f_min[c] + (f_max[c] - f_min[c]) * max((lengths[c] - n) / lengths[c], 0.0)
        return base_lr * f

    return sched


def build_lr_schedule(lr_function: Optional[str], base_lr: float, total_steps: int,
                      lr_params: Optional[dict] = None, lr_restarts: Optional[Sequence[int]] = None,
                      lr_restart_vals=1.0) -> Schedule:
    """schedule(step) -> absolute lr; step counts applied updates from 0."""
    p = dict(lr_params or {})
    if lr_restarts:
        return _restart_schedule(lr_function or "static", base_lr, total_steps, p, lr_restarts,
                                 lr_restart_vals)
    if lr_function is None or lr_function == "static":
        return lambda step: base_lr
    if lr_function == "piecewise_static":
        # base_lr x the multiplier of the first phase whose end >= step; the
        # last multiplier holds past the last phase
        ends = [float(e) for e, _ in p["piecewise_static_schedule"]]
        mults = [float(m) for _, m in p["piecewise_static_schedule"]]
        return lambda step: base_lr * mults[min(bisect.bisect_left(ends, step), len(ends) - 1)]
    if lr_function == "exponential":
        gamma = p.get("gamma", 0.98)
        return lambda step: base_lr * gamma ** float(step)
    if lr_function in ("polynomial", "linear-warmup-polynomial"):
        power, min_lr = p.get("power", 1.0), p.get("min_lr", 0.0)
        den = max(total_steps - 1, 1)  # total_steps 1 would divide 0 by 0

        def poly(step: int) -> float:
            return (base_lr - min_lr) * (1.0 - min(step, total_steps - 1) / den) ** power + min_lr

        if lr_function == "polynomial":
            return poly
        warmup_iters, warmup_rate = p["warmup_iters"], p["warmup_rate"]

        def warm_poly(step: int) -> float:
            if step <= warmup_iters - 1:
                return base_lr * (1.0 - (1.0 - (step + 1.0) / warmup_iters) * (1.0 - warmup_rate))
            return poly(step)

        return warm_poly
    if lr_function == "cosine":
        return lambda step: base_lr * 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps) / total_steps))
    if lr_function == "warmup-cosine":
        # LDM LambdaWarmUpCosineScheduler: lr_min / lr_max / lr_start multiply base_lr
        warm = p.get("warm_up_steps", 0)
        f_min, f_max, f_start = p.get("lr_min", 0.0), p.get("lr_max", 1.0), p.get("lr_start", 0.0)
        decay_steps = p.get("max_decay_steps", total_steps)

        def sched(step: int) -> float:
            if step < warm:
                return base_lr * (f_start + step / max(warm, 1) * (f_max - f_start))
            t = min((step - warm) / max(decay_steps - warm, 1), 1.0)
            return base_lr * (f_min + 0.5 * (f_max - f_min) * (1 + math.cos(t * math.pi)))

        return sched
    if lr_function in ("warmup-cosine2", "warmup-linear"):
        return _cyclic_schedule(lr_function, base_lr, total_steps, p)
    raise ValueError(f"unknown lr_function {lr_function!r}")


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / norm when their global L2 norm is
    at least max_norm (optax.clip_by_global_norm); returns the norm."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    if norm >= max_norm:
        torch._foreach_mul_(grads, max_norm / norm)  # == g / norm * max_norm up to rounding
    return norm


class Optimizer:
    """A torch optimizer over named parameters, its lr schedule, an optional
    global-norm clip and gradient accumulation over `accumulate_steps`
    micro-steps.  `count` is the number of updates applied; the schedule is
    evaluated at it before each update.  `state_dict` keys the per-parameter
    state (and the accumulated gradients) by parameter name."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                 make: Callable[[list], torch.optim.Optimizer], schedule: Schedule,
                 grad_clip: Optional[float] = None, accumulate_steps: int = 1):
        self.named_params = list(named_params)
        self.torch_opt = make([p for _, p in self.named_params])
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.count = 0
        self.accumulate_steps = accumulate_steps
        self.mini_step = 0  # micro-steps folded into acc_grads since the last update
        self.acc_grads = [torch.zeros_like(p) for _, p in self.named_params] if accumulate_steps > 1 else None

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from `grads` (in `named_params` order); with
        accumulate_steps k > 1, fold them into the running mean instead and
        apply the mean on the k-th micro-step."""
        grads = list(grads)
        if self.acc_grads is None:
            self._update(grads)
            return
        n = self.mini_step
        torch._foreach_add_(self.acc_grads, torch._foreach_div(torch._foreach_sub(grads, self.acc_grads), n + 1))
        self.mini_step = (n + 1) % self.accumulate_steps
        if self.mini_step == 0:
            self._update(self.acc_grads)
            torch._foreach_zero_(self.acc_grads)

    def _update(self, grads: list) -> None:
        if self.grad_clip is not None:
            clip_by_global_norm(grads, self.grad_clip)
        for (_, p), g in zip(self.named_params, grads):
            p.grad = g
        lr = float(self.schedule(self.count))
        for group in self.torch_opt.param_groups:
            group["lr"] = lr
        self.torch_opt.step()
        self.torch_opt.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        state = self.torch_opt.state
        sd = {"count": self.count,
              "state": {n: dict(state[p]) for n, p in self.named_params if p in state}}
        if self.acc_grads is not None:  # a resume inside an accumulation continues it
            sd["accumulate_steps"] = self.accumulate_steps
            sd["mini_step"] = self.mini_step
            sd["acc_grads"] = {n: a for (n, _), a in zip(self.named_params, self.acc_grads)}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Raises ValueError on a state inside an accumulation (mini_step > 0)
        that this optimizer cannot continue: saved with another
        accumulate_steps, or with fewer accumulated gradients than parameters.
        A state without `accumulate_steps` (one bridged from optax.MultiSteps,
        which does not record it) is taken to match where its mini_step fits."""
        pending, saved_k = int(sd.get("mini_step", 0)), sd.get("accumulate_steps")
        acc = sd.get("acc_grads", {})
        if pending and (pending >= self.accumulate_steps
                        or (saved_k is not None and int(saved_k) != self.accumulate_steps)
                        or any(n not in acc for n, _ in self.named_params)):
            raise ValueError(f"the optimizer state is {pending} micro-steps into an accumulation (accumulate_steps "
                             f"{saved_k}, {len(acc)} accumulated gradients); this optimizer accumulates over "
                             f"{self.accumulate_steps} micro-steps and {len(self.named_params)} parameters")
        self.count = int(sd["count"])
        if self.acc_grads is not None:
            self.mini_step = pending
            with torch.no_grad():
                for (n, _), a in zip(self.named_params, self.acc_grads):
                    if n in acc:
                        a.copy_(acc[n])
                    else:
                        a.zero_()
        self.torch_opt.state.clear()
        for n, p in self.named_params:
            if n in sd["state"]:
                # torch keeps Adam's `step` on the CPU unless capturable/fused
                self.torch_opt.state[p] = {k: v if k == "step" else v.to(p.device)
                                           for k, v in sd["state"][n].items()}


def build_optimizer(named_params: Sequence[Tuple[str, torch.nn.Parameter]], name: str = "AdamW",
                    learning_rate: float = 1e-3, lr_function: Optional[str] = None,
                    lr_params: Optional[dict] = None, total_steps: int = 1,
                    weight_decay: Optional[float] = None, betas: Sequence[float] = (0.9, 0.999),
                    momentum: float = 0.9, grad_clip: Optional[float] = None,
                    accumulate_steps: int = 1, lr_restarts: Optional[Sequence[int]] = None,
                    lr_restart_vals=1.0) -> Optimizer:
    """The JAX package's build_optimizer over `named_params`
    (`module.named_parameters()`): SGD wd 5e-4 momentum 0.9; Adam; AdamW wd
    0.01; `accumulate_steps` > 1 wraps it as optax.MultiSteps does.  Numbers
    that arrive as YAML strings ("1e-3") are coerced."""
    learning_rate = float(learning_rate)
    grad_clip = None if grad_clip is None else float(grad_clip)
    b1, b2 = (float(b) for b in betas)
    sched = build_lr_schedule(lr_function, learning_rate, total_steps, lr_params, lr_restarts,
                              lr_restart_vals)
    wd = None if weight_decay is None else float(weight_decay)
    if name == "SGD":
        make = lambda ps: torch.optim.SGD(ps, lr=learning_rate, momentum=float(momentum),
                                          weight_decay=0.0005 if wd is None else wd)
    elif name == "Adam":
        make = lambda ps: torch.optim.Adam(ps, lr=learning_rate, betas=(b1, b2), eps=1e-8)
    elif name == "AdamW":
        make = lambda ps: torch.optim.AdamW(ps, lr=learning_rate, betas=(b1, b2), eps=1e-8,
                                            weight_decay=0.01 if wd is None else wd)
    else:
        raise ValueError(f"optimizer {name!r} not recognized")
    return Optimizer(named_params, make, sched, grad_clip, int(accumulate_steps))
