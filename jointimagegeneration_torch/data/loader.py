"""Batching loader with thread-pool item decode and prefetch to the device.

Counterpart of `jointimagegeneration_tpu/data/loader.py` for one process:
each epoch draws the permutation `default_rng(seed + epoch)`, items are
loaded by `num_workers` threads with `num_workers + prefetch` batches in
flight, and each batch is stacked and sent to `device` (from pinned memory,
non-blocking, on CUDA).  Process sharding (torch.distributed) is not ported.
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

__all__ = ["DataLoader"]


def _stack_batch(items) -> dict:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals  # strings stay lists
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, device: Optional[torch.device] = None, prefetch: int = 2,
                 num_workers: int = 2):
        if drop_last and len(dataset) < batch_size:
            # zero batches per epoch would spin the train loop forever
            raise ValueError(f"dataset ({len(dataset)} items) smaller than batch_size ({batch_size}); "
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
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        return idx

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
