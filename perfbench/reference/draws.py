"""The program's draw rule, frozen here so that the reference replays the
draws the program took from a seed.

Copied from `jointimagegeneration_torch/diffusion/noise.py` (`NoiseSource`):
one `torch.Generator` on the device, seeded with the seed; a normal is
`torch.randn(shape, generator=g)`, a Gumbel is -log(-log(max(U, tiny))) with
U = `torch.rand(shape, generator=g)`, an integer draw `torch.randint(low,
high, shape, generator=g)`.  Draws are taken in the program's order, so the
n-th call here gives the program's n-th draw.
"""

from __future__ import annotations

import torch

__all__ = ["Replay"]


class Replay:
    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.device = torch.device(device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def gumbel(self, shape) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))

    def randint(self, low: int, high: int, shape) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.generator, device=self.device)
