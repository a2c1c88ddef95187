"""The training loop.

Counterpart of `jointimagegeneration_tpu/train/trainer.py`, run eagerly:
  for each batch: train step -> every `log_every` steps the metrics to
  `metrics.jsonl` (with imgs/s, the step's seconds, the seconds the loop
  waited for the step's batch (`data_seconds`) and the card's memory
  watermarks) -> every `save_every` steps a rolling checkpoint -> every
  `save_weights_every` steps a weight-only snapshot -> every `eval_every`
  steps `eval_fn`, whose score goes into the best-k checkpoints.

Under data parallelism (`parallel/mesh.py`, one process per GPU) every rank
runs this loop on its rows of each batch, with the step's noise source cut to
its rows (`rank_rows`), the gradients averaged in the train state and the
logged metrics averaged over the ranks (`mean_over_ranks`: the loss is the
global batch's, as the JAX step's psum gives it); only the chief (rank 0)
writes the metrics, the checkpoints and the run config
(the JAX trainer's `is_chief()` gates), while validation runs on every rank
with no logger on the others.  Every rank restores the checkpoint on resume.

Failure handling as in the JAX package: a logged non-finite loss, or any
skipped non-finite update, saves a debug checkpoint (the last good state:
EMATrainState never applies a non-finite update) and raises
FloatingPointError; SIGUSR1 saves at the next step; SIGUSR2 drops into `pdb`;
SIGTERM saves and stops cleanly; KeyboardInterrupt saves before it
propagates.  The chief archives the code (`utils.misc.archive_code`, failures
swallowed) into the logdir at start.

`profile_steps: N` (chief only) traces N steps with `torch.profiler` (CPU
activity, and CUDA on the card), from the third step after the start, or
from the first when the run has no more than N + 3 steps left, as the JAX
trainer decides; the chrome trace goes to `<logdir>/profile/` and the top
kernel kinds of its device time are printed (`core.logging.summarize_trace`;
a CPU run's top-level ops where no device kernel ran).  `resume` restores the
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
from ..parallel.mesh import is_chief, mean_over_ranks, rank_rows, world_size
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
    profile_steps: int = 0  # steps traced into <logdir>/profile; 0 = off
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
        self.cfg = config
        self.state = state
        self.train_step = train_step
        self.train_loader = train_loader
        self.device = device
        self.eval_fn = eval_fn
        self.chief = is_chief()
        self.logger = MetricLogger(config.logdir) if self.chief else None
        ckdir = Path(config.logdir) / "checkpoints"
        # the other ranks only read it, on resume
        self.ckpt = (CheckpointManager(ckdir, config.keep_checkpoints, best_mode=config.best_mode,
                                       best_k=config.keep_best) if self.chief or ckdir.is_dir() else None)
        if resume and self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.state.load_state_dict(self.ckpt.restore())
            print(f"resumed from step {self.state.step}")
        if self.chief:
            try:
                from ..utils.misc import archive_code

                archive_code(config.logdir)
            except Exception:
                pass
        if run_config is not None and self.chief:
            # the merged config of the run; the JAX trainer writes it as YAML
            cfg_dir = Path(config.logdir) / "configs"
            cfg_dir.mkdir(parents=True, exist_ok=True)
            (cfg_dir / "run-config.json").write_text(json.dumps(run_config, indent=1, default=str))
        self._usr1 = False
        self._term = False

    def fit(self) -> EMATrainState:
        """Train to `max_steps`; installs the SIGUSR1 / SIGUSR2 / SIGTERM
        handlers for the duration (in the main thread) and restores the
        previous ones."""
        handlers = {}
        if threading.current_thread() is threading.main_thread():
            handlers[signal.SIGUSR1] = signal.signal(signal.SIGUSR1, lambda *_: setattr(self, "_usr1", True))
            handlers[signal.SIGUSR2] = signal.signal(signal.SIGUSR2, self._divein)
            handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, lambda *_: setattr(self, "_term", True))
        try:
            return self._fit()
        finally:
            for sig, old in handlers.items():
                signal.signal(sig, old)
            if self.logger is not None:
                self.logger.close()

    @staticmethod
    def _divein(*_):
        import pdb

        pdb.set_trace()

    def _profile_start(self, step: int) -> Optional[int]:
        """The step number the trace starts at (the JAX window), or None."""
        n = self.cfg.profile_steps
        if not n or not self.chief:
            return None
        return step + 3 if self.cfg.max_steps - step > n + 3 else step + 1

    def _profile_stop(self, prof, step: int) -> None:
        synchronize(self.device)
        prof.__exit__(None, None, None)
        out = Path(self.cfg.logdir) / "profile"
        out.mkdir(parents=True, exist_ok=True)
        trace = out / f"trace_step{step}.json"
        prof.export_chrome_trace(str(trace))
        self._print_trace_summary(trace)

    def _print_trace_summary(self, trace, top_k: int = 10) -> None:
        from ..core.logging import summarize_trace

        try:
            rows = summarize_trace(trace, top_k=top_k)
        except Exception as e:
            print(f"profiler: trace summary unavailable: {e}")
            return
        if not rows:
            print(f"profiler: trace written to {trace} (no events parsed)")
            return
        total = sum(r[1] for r in rows)
        print(f"profiler: {self.cfg.profile_steps}-step trace ({trace}), top categories:")
        for key, ms, count in rows[:top_k]:
            print(f"  {key:<28s} {ms:9.2f} ms ({100 * ms / max(total, 1e-9):5.1f}%)  n={count}")

    def _save(self, step: int, score: Optional[float] = None) -> None:
        if self.chief:
            self.ckpt.save(step, self.state.state_dict(), score=score)

    def _fit(self) -> EMATrainState:
        cfg, state = self.cfg, self.state
        step = state.step
        noise = rank_rows(NoiseSource(noise_seed(cfg.seed, step), self.device))
        tput = Throughput()
        prof_start, prof = self._profile_start(step), None
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
                    if prof_start is not None and prof is None and step + 1 == prof_start:
                        acts = [torch.profiler.ProfilerActivity.CPU]
                        if self.device.type == "cuda":
                            acts.append(torch.profiler.ProfilerActivity.CUDA)
                        prof = torch.profiler.profile(activities=acts)
                        prof.__enter__()
                    t0 = time.perf_counter()
                    metrics = self.train_step(state, arrays, noise)
                    step += 1
                    if prof is not None and step >= prof_start + cfg.profile_steps - 1:
                        self._profile_stop(prof, step)
                        prof, prof_start = None, None
                    tput.update(next(iter(arrays.values())).shape[0] * world_size())  # the global batch
                    if log_now:
                        synchronize(self.device)
                        metrics = mean_over_ranks(metrics, self.device)
                        metrics["step_seconds"] = time.perf_counter() - t0
                        metrics["data_seconds"] = data_seconds
                        metrics["nonfinite_skipped"] = float(state.nonfinite_count)
                        if not math.isfinite(metrics.get("loss", 0.0)) or state.nonfinite_count > 0:
                            self._save(step)
                            raise FloatingPointError(f"non-finite loss/grads at step {step}: {metrics}")
                        metrics["imgs_per_sec"] = tput.rate()
                        metrics.update(hbm_stats(self.device))
                        if self.logger is not None:
                            self.logger.scalars(step, metrics, "train/")
                        tput.reset()

                    saved = False
                    if step % cfg.save_every == 0 or self._usr1:
                        self._save(step)
                        self._usr1, saved = False, True
                    if self._term:
                        if not saved:
                            self._save(step)
                        print(f"SIGTERM: checkpointed step {step}, stopping")
                        return state
                    if cfg.save_weights_every and step % cfg.save_weights_every == 0 and self.chief:
                        sd = state.state_dict()
                        self.ckpt.save_weights(step, {k: sd[k] for k in ("params", "ema", "step")})
                    if self.eval_fn is not None and step % cfg.eval_every == 0:
                        score = self.eval_fn(state, step, self.logger)
                        if score is not None:
                            self._save(step, score=float(score))
                    waited_from = time.perf_counter()
                if epoch_batches == 0:
                    raise RuntimeError("train_loader yielded no batches this epoch: empty dataset "
                                       "or exhausted one-shot iterator?")
        except KeyboardInterrupt:
            print("interrupted: saving checkpoint")
            self._save(step)
            raise
        finally:
            if prof is not None:  # the run ended inside the window
                prof.__exit__(None, None, None)
        return state
