"""The one source of random draws for the samplers.

Every random number the samplers and the train steps use comes from a
`NoiseSource`: standard normals (DDIM x_T, the stage-2 training noise),
standard Gumbels (categorical draws, as argmax(logits + Gumbel)), uniform
integers (the stage-2 training timesteps) and uniforms in [0, 1) (the text
refiner's dropout masks).  The draws come in a fixed order,
so a test can hand the samplers and steps a source that replays another
implementation's numbers.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["NoiseSource"]


class NoiseSource:
    """Draws from a `torch.Generator` on `device`, seeded with `seed`."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        """-log(-log(U)), U uniform in [tiny, 1) (jax.random.gumbel's form)."""
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """Floats uniform in [0, 1), fp32."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def randint(self, low: int, high: int, shape: Sequence[int]) -> torch.Tensor:
        """Integers uniform in [low, high), int64."""
        return torch.randint(low, high, tuple(shape), generator=self.generator, device=self.device)
