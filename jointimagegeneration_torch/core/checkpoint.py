"""Checkpoints as `torch.save` files, with the JAX package's retention policies.

Counterpart of `jointimagegeneration_tpu/core/checkpoint.py` (which writes
orbax trees; the port neither reads nor writes those).  Under `directory`:

  * `<step>.pt` — rolling saves (score-less), the newest `max_to_keep` kept;
  * `best/<step>.pt` — scored saves; the `best_k` best by score (`best_mode`
    max or min) kept, scores in `best/scores.json`;
  * `trainstep/<step>.pt` — weight-only snapshots (`save_weights`), all kept.

Each file is written to a temporary name in its directory and renamed into
place (`os.replace`), so a crash mid-write never leaves a partial checkpoint
under a step's name.  `restore` loads with `weights_only=True`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

__all__ = ["CheckpointManager"]


def _atomic_save(obj: Any, path: Path) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: Path) -> List[int]:
    return sorted(int(p.stem) for p in directory.glob("*.pt") if p.stem.isdigit())


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3, best_mode: str = "max", best_k: int = 1):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_mode = best_mode
        self.best_k = best_k

    @property
    def _best_dir(self) -> Path:
        return self.directory / "best"

    def _scores(self) -> Dict[int, float]:
        f = self._best_dir / "scores.json"
        return {int(k): v for k, v in json.loads(f.read_text()).items()} if f.exists() else {}

    def save(self, step: int, state: Any, score: Optional[float] = None) -> None:
        """Score-less saves roll (FIFO `max_to_keep`); scored saves compete in
        the best-k tree.  A step that belongs in both is saved by two calls."""
        if score is None:
            _atomic_save(state, self.directory / f"{step}.pt")
            for old in _steps(self.directory)[:-self.max_to_keep]:
                (self.directory / f"{old}.pt").unlink()
            return
        self._best_dir.mkdir(exist_ok=True)
        scores = self._scores()
        scores[int(step)] = float(score)
        ranked = sorted(scores, key=lambda s: scores[s], reverse=self.best_mode == "max")
        keep = set(ranked[:self.best_k])
        if step in keep:
            _atomic_save(state, self._best_dir / f"{step}.pt")
        tmp = self._best_dir / f".scores.json.{os.getpid()}.tmp"
        tmp.write_text(json.dumps({str(s): scores[s] for s in sorted(keep)}))
        os.replace(tmp, self._best_dir / "scores.json")
        for old in _steps(self._best_dir):
            if old not in keep:
                (self._best_dir / f"{old}.pt").unlink()

    def save_weights(self, step: int, weights: Any) -> None:
        """Weight-only snapshot under `trainstep/`, never pruned."""
        d = self.directory / "trainstep"
        d.mkdir(exist_ok=True)
        _atomic_save(weights, d / f"{step}.pt")

    def all_steps(self) -> Dict[str, List[int]]:
        """{'rolling': [...], 'best': [...], 'trainstep': [...]} retained steps."""
        sub = lambda name: _steps(self.directory / name) if (self.directory / name).exists() else []
        return {"rolling": _steps(self.directory), "best": sub("best"), "trainstep": sub("trainstep")}

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        found = steps["rolling"] + steps["best"]
        return max(found) if found else None

    def best_step(self) -> Optional[int]:
        scores = self._scores()
        if not scores:
            return None
        return (max if self.best_mode == "max" else min)(scores, key=lambda s: scores[s])

    def step_path(self, step: Optional[int] = None) -> Path:
        """The file of `step` (default: the latest), rolling before best."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        for path in (self.directory / f"{step}.pt", self._best_dir / f"{step}.pt"):
            if path.exists():
                return path
        raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")

    def restore(self, step: Optional[int] = None) -> Any:
        """The saved object at `step` (default: the latest), on the CPU."""
        return torch.load(self.step_path(step), map_location="cpu", weights_only=True)
