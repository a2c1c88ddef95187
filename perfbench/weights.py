"""Seeded weights, made on the device by parameter name and shape.

The same dict loads into the program's UNet (`load_state_dict`) and feeds the
plain reference, so both compute with one set of numbers that neither made.
All leaves come from one normal draw of their total size on a generator on
the device, cut in name order and scaled by kind:
  * kernels and linear weights (2 or more dims): N(0, 1 / fan_in), the
    output convolutions that a fresh model zero-initialises too, so that
    every path carries signal (the CLIs' `fresh_init_noise` does the same);
  * GroupNorm scales (1-dim, named `*scale` or `norm*.weight`): 1 + N(0, 0.1^2);
  * biases and GroupNorm shifts: N(0, 0.02^2).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

__all__ = ["make_weights"]


def _is_scale(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return leaf.endswith("scale") or (leaf == "weight" and "norm" in name.rsplit(".", 2)[-2])


@torch.no_grad()
def make_weights(shapes: Mapping[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} for every (name, shape), from `seed`."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        shape = tuple(shapes[name])
        if len(shape) >= 2:
            std, mean = 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
        elif _is_scale(name):
            std, mean = 0.1, 1.0
        else:
            std, mean = 0.02, 0.0
        out[name] = part.view(shape).mul_(std).add_(mean)
    return out
