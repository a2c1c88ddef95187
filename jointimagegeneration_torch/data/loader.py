"""Batching loader with thread-pool item decode and prefetch to the device.

Counterpart of `jointimagegeneration_tpu/data/loader.py`: each epoch draws
the permutation `default_rng(seed + epoch)` and this process keeps its
contiguous shard of it (rank r of W from `parallel/mesh.py`: the n // W
indices from r (n // W), the DistributedSampler's role),
items are loaded by `num_workers` threads with `num_workers + prefetch`
batches in flight, and each batch is stacked and sent to `device` (from
pinned memory, non-blocking, on CUDA).  `batch_size` is this process's rows
(the trainers pass the global batch over W).  Arrays are stacked, numbers
(the stock `imagenet` kind's `class_label`) become an array too, so that an
'adm' UNet's class ids reach the train step (the JAX loader keeps them a list,
which its trainer drops); strings stay lists.
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from ..parallel import mesh

__all__ = ["DataLoader"]


def _stack_batch(items) -> dict:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.number)) and not isinstance(vals[0], bool):
            out[k] = np.asarray(vals)  # numbers (class_label) as an array, so they reach the step
        else:
            out[k] = vals  # strings stay lists
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, device: Optional[torch.device] = None, prefetch: int = 2,
                 num_workers: int = 2):
        self.rank, self.world = mesh.rank(), mesh.world_size()
        per_process = len(dataset) // self.world
        if drop_last and per_process < batch_size:
            # zero batches per epoch would spin the train loop forever
            raise ValueError(f"dataset shard ({per_process} items) smaller than batch_size ({batch_size}); "
                             "reduce batch_size or set drop_last=False")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.device = torch.device("cpu" if device is None else device)
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.world
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        per = len(idx) // self.world
        return idx[self.rank * per:(self.rank + 1) * per]

    def _to_device(self, batch: dict) -> dict:
        def put(v):
            if not isinstance(v, np.ndarray):
                return v
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        return {k: put(v) for k, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if callable(set_epoch):  # datasets that vary their augmentation by epoch
            set_epoch(self.epoch)
        self.epoch += 1
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

        def load(bidx):
            return _stack_batch([self.dataset[int(i)] for i in bidx])

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            it = iter(batches)
            futures = deque(ex.submit(load, b) for b in itertools.islice(it, self.num_workers + self.prefetch))
            while futures:
                batch = futures.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    futures.append(ex.submit(load, nxt))
                yield self._to_device(batch)
