"""Seeded organ-label volumes, made on the device.

Each volume is background (class 0) with one ellipsoid per further class,
later classes drawn over earlier ones; centres lie in the middle 60% of each
axis and radii are 5-22% of it, as abdominal organs fill a CT volume.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["label_volumes"]


@torch.no_grad()
def label_volumes(seed: int, batch: int, shape: Sequence[int], num_classes: int, device) -> torch.Tensor:
    """(batch, *shape) int64 labels in [0, num_classes)."""
    g = torch.Generator()
    g.manual_seed(seed)
    extent = torch.tensor(shape, dtype=torch.float32)
    centre = (0.2 + 0.6 * torch.rand(batch, num_classes - 1, 3, generator=g)) * extent
    radii = (0.05 + 0.17 * torch.rand(batch, num_classes - 1, 3, generator=g)) * extent
    grids = torch.meshgrid(*(torch.arange(s, device=device, dtype=torch.float32) for s in shape), indexing="ij")
    out = torch.zeros((batch, *shape), dtype=torch.int64, device=device)
    for b in range(batch):
        for k in range(num_classes - 1):
            c, r = centre[b, k].tolist(), radii[b, k].tolist()
            inside = sum(((grid - ci) / ri) ** 2 for grid, ci, ri in zip(grids, c, r)) <= 1.0
            out[b][inside] = k + 1
    return out
