"""Training metrics: JSONL scalars, PNG panels, TensorBoard, a throughput counter,
device memory, and the profiler trace's summary.

Counterpart of `jointimagegeneration_tpu/core/logging.py`:
`MetricLogger.scalars` appends one JSON record per call to
`<logdir>/metrics.jsonl` and, where `tensorboardX` (or else
`torch.utils.tensorboard`) imports, writes the scalars as TensorBoard events
under `<logdir>`; `MetricLogger.image` writes a panel to `<logdir>/images/`
(the newest 30 kept) and to TensorBoard.  A TensorBoard writer that cannot be
built or fails is dropped, never raised; the JSONL is always written.
`wandb_project` mirrors the scalars to W&B, imported only when asked for.
`Throughput` counts images per second, `hbm_stats` reads the card's memory
watermarks, and `summarize_trace` sums a `torch.profiler` trace's device
kernels by kind (`TRACE_KINDS`, the kinds `scripts/profile_torch_path.py`
reports), the counterpart of the JAX function over an XLA trace.
"""

from __future__ import annotations

import glob
import gzip
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..eval.writers import save_grid_png

__all__ = ["MetricLogger", "Throughput", "hbm_stats", "summarize_trace", "TRACE_KINDS", "kind_of"]

TRACE_KINDS = [  # (kind, pattern on the kernel name), first match wins
    ("conv3d_kernel", r"conv3d_wgmma_kernel|conv3d_ffma_kernel|splitk_reduce_kernel|stats_reduce_kernel"),
    ("flash_fwd", r"flash_fwd"),
    ("flash_bwd", r"flash_bwd|delta_f32_kernel|splits_reduce_f32_kernel"),
    ("optimizer", r"multi_tensor_apply|foreach|adam"),
    ("conv", r"xmma_fprop|implicit_gemm|conv|cudnn|wgrad|dgrad"),
    ("matmul", r"gemm|cutlass|cublas"),
    ("norm_reduce", r"reduce_kernel|welford"),
    ("copy_cast", r"copy_kernel|catarray|cat_batched"),
    ("elementwise", r"elementwise|silu|softmax|index"),
]


def kind_of(name: str) -> str:
    for kind, pat in TRACE_KINDS:
        if re.search(pat, name, re.IGNORECASE):
            return kind
    return "other"


def _tensorboard_writer(logdir: Path):
    for module in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return __import__(module, fromlist=["SummaryWriter"]).SummaryWriter(str(logdir))
        except Exception:
            continue
    return None


class MetricLogger:
    def __init__(self, logdir, wandb_project: Optional[str] = None, wandb_mode: str = "offline"):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        # the PNG trail, oldest first (equal times by name, so by step within
        # a panel), seeded from disk so that the bound holds per run
        # directory across resumes
        self._pngs = sorted((self.logdir / "images").glob("*.png"), key=lambda p: (p.stat().st_mtime, p.name))
        self._tb = _tensorboard_writer(self.logdir)
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, mode=wandb_mode, dir=str(self.logdir))
            except Exception:
                self._wandb = None

    max_images = 30  # PNGs kept under images/; the oldest is unlinked

    def _to_tb(self, fn: str, *args, **kw) -> None:
        if self._tb is not None:
            try:
                getattr(self._tb, fn)(*args, **kw)
            except Exception:
                self._tb = None  # the JSONL and PNGs stay authoritative

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step), **{f"{prefix}{k}": float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        for name, v in rec.items():
            if name != "step":
                self._to_tb("add_scalar", name, v, int(step))
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "step"}, step=int(step))

    def image(self, step: int, name: str, img: np.ndarray) -> None:
        """Write `img` ((H, W, 3) uint8) as `images/<name>_gs-<step>.png`, '/'
        in the name as '_'; past `max_images` files the oldest goes."""
        path = self.logdir / "images" / f"{name.replace('/', '_')}_gs-{int(step):06d}.png"
        save_grid_png(path, img)
        self._to_tb("add_image", name, np.asarray(img), int(step), dataformats="HWC")
        if path in self._pngs:  # the same (name, step) again overwrote one file
            self._pngs.remove(path)
        self._pngs.append(path)
        while len(self._pngs) > self.max_images:
            self._pngs.pop(0).unlink(missing_ok=True)

    def close(self) -> None:
        self._jsonl.close()
        self._to_tb("close")


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


def summarize_trace(trace, top_k: int = 20, group: str = "category") -> List[Tuple[str, float, int]]:
    """[(key, total ms, count)], longest first, of the device kernels in a
    `torch.profiler` chrome trace: a `.json` (or `.json.gz`) file, or a
    directory holding them (the newest).
    `group` "category" sums by `TRACE_KINDS`, "name" by kernel name.  A trace
    with no device kernel (a CPU run) is summed over its top-level CPU ops,
    keyed "cpu:<op>"."""
    path = Path(trace)
    if path.is_dir():
        files = sorted(glob.glob(str(path / "**" / "*.json*"), recursive=True), key=lambda f: Path(f).stat().st_mtime)
        if not files:
            return []
        path = Path(files[-1])
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        raw = json.load(f).get("traceEvents", [])
    cpu = [e for e in raw if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    tops = []  # the CPU ops no other op of the same thread encloses
    for tid in {e.get("tid") for e in cpu}:
        end = -1.0
        for e in sorted((e for e in cpu if e.get("tid") == tid), key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                tops.append(e)
                end = e["ts"] + e["dur"]
    events = [(e["name"], float(e["dur"]), True) for e in raw
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    events += [(e["name"], float(e["dur"]), False) for e in tops]
    on_device = any(dev for _, _, dev in events)
    agg: Dict[str, list] = {}
    for name, us, dev in events:
        if dev != on_device:
            continue
        key = (kind_of(name) if group == "category" else name) if dev else f"cpu:{name}"
        row = agg.setdefault(key, [0.0, 0])
        row[0] += us / 1e3
        row[1] += 1
    return sorted(((k, ms, n) for k, (ms, n) in agg.items()), key=lambda r: -r[1])[:top_k]
