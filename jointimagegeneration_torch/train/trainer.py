"""The training loop.

Counterpart of `jointimagegeneration_tpu/train/trainer.py`, run eagerly:
  for each batch: train step -> every `log_every` steps the metrics to
  `metrics.jsonl` (with imgs/s, the step's seconds, the seconds the loop
  waited for the step's batch (`data_seconds`) and the card's memory
  watermarks) -> every `save_every` steps a rolling checkpoint -> every
  `save_weights_every` steps a weight-only snapshot -> every `eval_every`
  steps `eval_fn`, whose score goes into the best-k checkpoints.

Failure handling as in the JAX package: a logged non-finite loss, or any
skipped non-finite update, saves a debug checkpoint (the last good state:
EMATrainState never applies a non-finite update) and raises
FloatingPointError; SIGUSR1 saves at the next step; SIGTERM saves and stops
cleanly; KeyboardInterrupt saves before it propagates.  `resume` restores the
latest checkpoint, and the noise stream is seeded from (seed, restored step),
so a resumed run continues the random draws instead of replaying them.
"""

from __future__ import annotations

import json
import math
import signal
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.logging import MetricLogger, Throughput, hbm_stats
from ..core.runtime import synchronize
from ..diffusion.noise import NoiseSource
from .state import EMATrainState

__all__ = ["Trainer", "TrainerConfig", "noise_seed"]


@dataclass
class TrainerConfig:
    logdir: str = "runs/exp"
    max_steps: int = 10_000
    log_every: int = 50
    save_every: int = 1000
    eval_every: int = 1000
    keep_checkpoints: int = 3
    keep_best: int = 1
    best_mode: str = "max"
    save_weights_every: Optional[int] = None  # weight-only snapshots, kept forever; None = off
    profile_steps: int = 0  # not ported: scripts/profile_torch_path.py profiles the port
    seed: int = 0


def noise_seed(seed: int, step: int) -> int:
    """The seed of a run's noise stream when it starts (or resumes) at `step`."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class Trainer:
    def __init__(self, config: TrainerConfig, state: EMATrainState,
                 train_step: Callable,  # (state, batch, noise) -> metrics
                 train_loader, device: torch.device,
                 eval_fn: Optional[Callable] = None,  # (state, step, logger) -> score
                 resume: bool = False, run_config: Optional[dict] = None):
        if config.profile_steps:
            raise NotImplementedError("profile_steps: the port is profiled by scripts/profile_torch_path.py")
        self.cfg = config
        self.state = state
        self.train_step = train_step
        self.train_loader = train_loader
        self.device = device
        self.eval_fn = eval_fn
        self.logger = MetricLogger(config.logdir)
        self.ckpt = CheckpointManager(Path(config.logdir) / "checkpoints", config.keep_checkpoints,
                                      best_mode=config.best_mode, best_k=config.keep_best)
        if resume and self.ckpt.latest_step() is not None:
            self.state.load_state_dict(self.ckpt.restore())
            print(f"resumed from step {self.state.step}")
        if run_config is not None:
            # the merged config of the run; the JAX trainer writes it as YAML
            cfg_dir = Path(config.logdir) / "configs"
            cfg_dir.mkdir(parents=True, exist_ok=True)
            (cfg_dir / "run-config.json").write_text(json.dumps(run_config, indent=1, default=str))
        self._usr1 = False
        self._term = False

    def fit(self) -> EMATrainState:
        """Train to `max_steps`; installs the SIGUSR1 / SIGTERM handlers for
        the duration (in the main thread) and restores the previous ones."""
        handlers = {}
        if threading.current_thread() is threading.main_thread():
            handlers[signal.SIGUSR1] = signal.signal(signal.SIGUSR1, lambda *_: setattr(self, "_usr1", True))
            handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, lambda *_: setattr(self, "_term", True))
        try:
            return self._fit()
        finally:
            for sig, old in handlers.items():
                signal.signal(sig, old)
            self.logger.close()

    def _fit(self) -> EMATrainState:
        cfg, state = self.cfg, self.state
        step = state.step
        noise = NoiseSource(noise_seed(cfg.seed, step), self.device)
        tput = Throughput()
        try:
            while step < cfg.max_steps:
                epoch_batches = 0
                waited_from = time.perf_counter()
                for batch in self.train_loader:
                    data_seconds = time.perf_counter() - waited_from
                    epoch_batches += 1
                    if step >= cfg.max_steps:
                        break
                    arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
                    log_now = (step + 1) % cfg.log_every == 0
                    t0 = time.perf_counter()
                    metrics = self.train_step(state, arrays, noise)
                    step += 1
                    tput.update(next(iter(arrays.values())).shape[0])
                    if log_now:
                        synchronize(self.device)
                        metrics = {k: float(v) for k, v in metrics.items()}
                        metrics["step_seconds"] = time.perf_counter() - t0
                        metrics["data_seconds"] = data_seconds
                        metrics["nonfinite_skipped"] = float(state.nonfinite_count)
                        if not math.isfinite(metrics.get("loss", 0.0)) or state.nonfinite_count > 0:
                            self.ckpt.save(step, state.state_dict())
                            raise FloatingPointError(f"non-finite loss/grads at step {step}: {metrics}")
                        metrics["imgs_per_sec"] = tput.rate()
                        metrics.update(hbm_stats(self.device))
                        self.logger.scalars(step, metrics, "train/")
                        tput.reset()

                    saved = False
                    if step % cfg.save_every == 0 or self._usr1:
                        self.ckpt.save(step, state.state_dict())
                        self._usr1, saved = False, True
                    if self._term:
                        if not saved:
                            self.ckpt.save(step, state.state_dict())
                        print(f"SIGTERM: checkpointed step {step}, stopping")
                        return state
                    if cfg.save_weights_every and step % cfg.save_weights_every == 0:
                        sd = state.state_dict()
                        self.ckpt.save_weights(step, {k: sd[k] for k in ("params", "ema", "step")})
                    if self.eval_fn is not None and step % cfg.eval_every == 0:
                        score = self.eval_fn(state, step, self.logger)
                        if score is not None:
                            self.ckpt.save(step, state.state_dict(), score=float(score))
                    waited_from = time.perf_counter()
                if epoch_batches == 0:
                    raise RuntimeError("train_loader yielded no batches this epoch: empty dataset "
                                       "or exhausted one-shot iterator?")
        except KeyboardInterrupt:
            print("interrupted: saving checkpoint")
            self.ckpt.save(step, state.state_dict())
            raise
        return state
