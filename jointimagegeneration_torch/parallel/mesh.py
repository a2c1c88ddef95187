"""Data parallelism over torch.distributed: the 'data' axis of the JAX mesh.

Counterpart of `jointimagegeneration_tpu/parallel/mesh.py` with one process
per GPU, as torchrun starts them:

  * `maybe_initialize_distributed` joins the process group that the
    launcher's environment describes (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT, as torchrun sets them; the counterpart of
    JAX_COORDINATOR_ADDRESS) and does nothing without it: NCCL on CUDA, each
    process on the card LOCAL_RANK, gloo for `device='cpu'`;
  * `batch_size` in a config is the GLOBAL batch, as in the JAX CLIs: each of
    W ranks trains on batch_size / W rows (`local_batch_size`), and a batch
    that W does not divide raises ValueError (the JAX single-host mesh drops
    devices instead, but a process group cannot leave a rank idle without
    hanging it);
  * `average_gradients` is the gradient psum over 'data': a sum all-reduce
    and a division by W, before the clip and the optimizer;
    `mean_over_ranks` likewise makes a step's logged metrics (its loss) the
    global batch's, as the JAX step's are;
  * `rank_rows` wraps a step's noise source so that each rank draws the
    global batch's numbers (t, noise, dropout) and keeps its own rows: a
    W-rank step computes the one-process step of the concatenated batch;
  * `is_chief` gates the metrics, the checkpoints and the run config.

The 'model' axis (spatial sharding of the UNet) is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "world_size", "rank", "is_chief", "local_batch_size",
           "average_gradients", "mean_over_ranks", "rank_rows"]

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(device) -> torch.device:
    """Join the launcher's process group when its environment is set, and
    return the device this process runs on (`cuda:LOCAL_RANK` under a CUDA
    group); without the environment return `device` and start nothing."""
    device = torch.device(device)
    if not _active():
        if not all(os.environ.get(k) for k in _LAUNCH_ENV):
            return device
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def rank() -> int:
    return dist.get_rank() if _active() else 0


def is_chief() -> bool:
    """Rank 0 (the reference's idist.one_rank_only / rank_zero_only)."""
    return rank() == 0


def local_batch_size(batch_size: int) -> int:
    """This rank's rows of a global `batch_size`; ValueError unless the
    world size divides it."""
    w = world_size()
    if batch_size % w:
        raise ValueError(f"batch_size {batch_size} (the global batch) is not divisible by the {w} ranks; "
                         "choose a multiple of the world size")
    return batch_size // w


def average_gradients(grads: Sequence[Optional[torch.Tensor]]) -> None:
    """Replace each gradient by its mean over the ranks, in place: one sum
    all-reduce of the gradients flattened per dtype, then a division by W
    (also in a group of one rank; without a group, nothing).  None entries
    (unused parameters, alike on every rank) are skipped."""
    if not _active():
        return
    w = world_size()
    by_dtype = {}
    for g in grads:
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat)
        flat.div_(w)
        offset = 0
        for g in gs:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mean_over_ranks(metrics: Dict[str, object], device) -> Dict[str, float]:
    """Each scalar of `metrics` as a float, averaged over the ranks (one sum
    all-reduce of them stacked on `device`, then a division by W) when a
    group is active.  Every rank must call it at the same step."""
    if not _active():
        return {k: float(v) for k, v in metrics.items()}
    keys = list(metrics)
    flat = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device).reshape(())
                        for k in keys])
    dist.all_reduce(flat)
    flat.div_(world_size())
    return dict(zip(keys, flat.tolist()))


class _RankRows:
    """A noise source that draws each request for the global batch (its
    leading axis times W) from `noise` and returns this rank's rows."""

    def __init__(self, noise, rank_: int, world: int):
        self.noise, self.rank, self.world = noise, rank_, world
        self.device = noise.device

    def _rows(self, draw: torch.Tensor) -> torch.Tensor:
        b = draw.shape[0] // self.world
        return draw[self.rank * b:(self.rank + 1) * b]

    def _global(self, shape) -> List[int]:
        return [int(shape[0]) * self.world, *shape[1:]]

    def normal(self, shape):
        return self._rows(self.noise.normal(self._global(shape)))

    def gumbel(self, shape):
        return self._rows(self.noise.gumbel(self._global(shape)))

    def uniform(self, shape):
        return self._rows(self.noise.uniform(self._global(shape)))

    def randint(self, low: int, high: int, shape):
        return self._rows(self.noise.randint(low, high, self._global(shape)))


def rank_rows(noise):
    """`noise` itself on one rank; else its global-batch draws cut to this
    rank's rows.  Every draw of a train step is batch-first."""
    w = world_size()
    return noise if w == 1 else _RankRows(noise, rank(), w)
