"""The JAX package's ('data', 'model') mesh: data parallelism over
torch.distributed for training, and a single-controller device grid for
sampling and spatial sharding.

Counterpart of `jointimagegeneration_tpu/parallel/mesh.py`.  The trainers
run one process per GPU, as torchrun starts them:

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

Within one process, `Mesh` is a (data, model) grid of devices that the
process drives itself, as one JAX process drives every device of its mesh
(the tests and the one-card smoke repeat a device):
  * `make_mesh(data, model, devices)` lays out the grid: `devices` defaults
    to this process's cards (under torchrun the `model` cards from
    LOCAL_RANK * model on, the 'model' axis inside one host as the JAX layout
    keeps it on ICI neighbours); too few devices raise ValueError;
  * `make_mesh_for_batch(batch_size, model)` takes the largest data extent
    that divides the batch, over the local cards (`local_devices`), as the
    JAX CLIs' batched sampling does;
  * `replicate` copies a module once per distinct device of a mesh; a
    repeated device, and the module's own, share its copy;
  * `shard_batch` cuts a batch's rows over the data axis;
  * the 'model' axis shards the UNet's activations along their leading
    spatial axis (`nn.unet.UNet(spatial_axis="model", mesh=...)`, the
    exchanges in `parallel/spatial.py`).
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.runtime import resolve_device

__all__ = ["maybe_initialize_distributed", "world_size", "rank", "is_chief", "local_batch_size",
           "average_gradients", "mean_over_ranks", "rank_rows", "Mesh", "local_devices", "make_mesh",
           "make_mesh_for_batch", "replicate", "shard_batch"]

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


class Mesh:
    """A ('data', 'model') grid of devices that one process drives: row r
    holds the 'model' devices of data index r.  A device may appear more
    than once."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or len({len(row) for row in self.devices}) != 1 or not self.devices[0]:
            raise ValueError(f"a mesh needs equal non-empty rows, got {devices}")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def distinct(self) -> List[torch.device]:
        """Each device once, in grid order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def _resolved(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices(device=None) -> List[torch.device]:
    """This process's devices of `device`'s kind: every local card for CUDA
    (the default, through `resolve_device`'s rule), else `device` alone."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(data: Optional[int] = None, model: int = 1, devices: Optional[Sequence] = None,
              device=None) -> Mesh:
    """A data x model mesh over `devices` (default: this process's cards of
    `device`'s kind; under torchrun with `data` unset, the `model` cards from
    LOCAL_RANK * model on).  `data` defaults to what the devices fill;
    ValueError unless data * model devices are given."""
    if devices is None:
        devices = local_devices(device)
        if data is None and "LOCAL_RANK" in os.environ and model > 1:
            start = int(os.environ["LOCAL_RANK"]) * model
            devices = devices[start:start + model]
    devices = [_resolved(torch.device(d)) for d in devices]
    n = len(devices)
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh axes must be >= 1, got data={data}, model={model}")
    if data is None:
        data = n // model
    if data < 1 or data * model != n:
        raise ValueError(f"a {data or '?'} x {model} mesh needs {max(data, 1) * model} devices, {n} given")
    return Mesh([devices[r * model:(r + 1) * model] for r in range(data)])


def make_mesh_for_batch(batch_size: int, model: int = 1, device=None) -> Mesh:
    """The mesh of a batched sampling call: its data extent the largest one
    (at most the local cards / `model`) that divides `batch_size`."""
    devices = local_devices(device)
    max_data = max(1, len(devices) // model)
    data = max(d for d in range(1, max_data + 1) if max(1, batch_size) % d == 0)
    use = devices[:data * model]
    if len(use) < len(devices) and is_chief():
        print(f"mesh: batch_size={batch_size} not divisible by {len(devices)} devices; "
              f"using {len(use)} ({data}x{model})")
    return make_mesh(data=data, model=model, devices=use)


def replicate(mesh: Mesh, module: torch.nn.Module) -> Dict[torch.device, torch.nn.Module]:
    """{device: module copy} for each distinct device of `mesh`: the module
    itself on its own device, a copy with its parameters and buffers on
    each other one (made outside inference mode, so it stays a normal
    module)."""
    own = _resolved(next(module.parameters()).device)
    out = {}
    with torch.inference_mode(False), torch.no_grad():
        for d in mesh.distinct():
            out[d] = module if d == own else copy.deepcopy(module).to(d)
    return out


def shard_batch(mesh: Mesh, batch: torch.Tensor) -> List[torch.Tensor]:
    """The rows of `batch` cut over the data axis, contiguously (the last
    rows may be fewer), each on its row's first device."""
    rows = torch.tensor_split(batch, len(mesh.devices))
    return [r.to(row[0]) for r, row in zip(rows, mesh.devices)]
