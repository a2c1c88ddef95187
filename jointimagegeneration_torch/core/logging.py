"""Training metrics: JSONL scalars, PNG panels, a throughput counter, device memory.

Counterpart of `jointimagegeneration_tpu/core/logging.py` for what the
trainer logs: `MetricLogger.scalars` appends one JSON record per call to
`<logdir>/metrics.jsonl`, `MetricLogger.image` writes a panel to
`<logdir>/images/` and keeps the newest 30 there, `Throughput` counts images
per second, and `hbm_stats` reads the card's memory watermarks.  Tensorboard
and wandb are not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..eval.writers import save_grid_png

__all__ = ["MetricLogger", "Throughput", "hbm_stats"]


class MetricLogger:
    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        # the PNG trail, oldest first (equal times by name, so by step within
        # a panel), seeded from disk so that the bound holds per run
        # directory across resumes
        self._pngs = sorted((self.logdir / "images").glob("*.png"), key=lambda p: (p.stat().st_mtime, p.name))

    max_images = 30  # PNGs kept under images/; the oldest is unlinked

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step), **{f"{prefix}{k}": float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def image(self, step: int, name: str, img: np.ndarray) -> None:
        """Write `img` ((H, W, 3) uint8) as `images/<name>_gs-<step>.png`, '/'
        in the name as '_'; past `max_images` files the oldest goes."""
        path = self.logdir / "images" / f"{name.replace('/', '_')}_gs-{int(step):06d}.png"
        save_grid_png(path, img)
        if path in self._pngs:  # the same (name, step) again overwrote one file
            self._pngs.remove(path)
        self._pngs.append(path)
        while len(self._pngs) > self.max_images:
            self._pngs.pop(0).unlink(missing_ok=True)

    def close(self) -> None:
        self._jsonl.close()


class Throughput:
    """Images per second since the last `reset`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._n = 0

    def update(self, n: int) -> None:
        self._n += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._n / dt if dt > 0 else 0.0


def hbm_stats(device: torch.device) -> Dict[str, float]:
    """{hbm_peak_gib: torch.cuda.max_memory_allocated, hbm_reserved_gib:
    torch.cuda.memory_reserved} in GiB on a CUDA device; {} elsewhere."""
    if device.type != "cuda":
        return {}
    return {"hbm_peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "hbm_reserved_gib": torch.cuda.memory_reserved(device) / 2**30}
