"""Sliding-window tiled apply with border-weighted stitching.

Counterpart of `jointimagegeneration_tpu/ops/tiling.py`: an oversized input
is processed as overlapping windows, each window's result weighted by its
distance to the window border, and the weighted results summed back in fp32
and normalised.  The windows run in a Python loop, row by row.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["border_weighting", "tiled_apply"]


def border_weighting(patch_hw: Tuple[int, int], alpha: float = 1e-2) -> np.ndarray:
    """(h, w) float32 weights: the normalised L1 distance to the nearest
    border, clipped to [alpha, 1]."""
    h, w = patch_hw
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    d = np.minimum(np.minimum(ys, 1 - ys)[:, None], np.minimum(xs, 1 - xs)[None, :]) * 2
    return np.clip(d, alpha, 1.0).astype(np.float32)


def _offsets(size: int, patch: int, stride: int) -> List[int]:
    """Window starts every `stride`, plus `size - patch` where the stride
    misses it."""
    if size <= patch:
        return [0]
    offs = list(range(0, size - patch + 1, stride))
    if offs[-1] != size - patch:
        offs.append(size - patch)
    return offs


def _scaled(v: int, s: float) -> int:
    sv = v * s
    if abs(sv - round(sv)) >= 1e-9:
        raise ValueError(f"{v} * out_scale={s} is not an integer")
    return int(round(sv))


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, patch: Tuple[int, int],
                stride: Tuple[int, int], out_channels: Optional[int] = None,
                out_scale: float = 1.0) -> torch.Tensor:
    """Apply `fn` ((B, ph, pw, C) -> (B, ph*s, pw*s, C')) over overlapping
    windows of x (B, H, W, C) and fold the results back with border
    weighting; returns (B, H*s, W*s, C') in x's dtype.  `out_scale` s is for
    resolution-changing fns; patch, stride and size must scale to integers."""
    b, h, w, c = x.shape
    ph, pw = patch
    pho, pwo = _scaled(ph, out_scale), _scaled(pw, out_scale)
    weight = torch.from_numpy(border_weighting((pho, pwo))).to(x.device)[None, :, :, None]
    acc = torch.zeros((b, _scaled(h, out_scale), _scaled(w, out_scale), out_channels or c),
                      dtype=torch.float32, device=x.device)
    norm = torch.zeros(acc.shape[:3] + (1,), dtype=torch.float32, device=x.device)
    for yi in _offsets(h, ph, stride[0]):
        for xi in _offsets(w, pw, stride[1]):
            y, xo = _scaled(yi, out_scale), _scaled(xi, out_scale)
            acc[:, y:y + pho, xo:xo + pwo] += fn(x[:, yi:yi + ph, xi:xi + pw]).float() * weight
            norm[:, y:y + pho, xo:xo + pwo] += weight
    return (acc / torch.clamp_min(norm, 1e-8)).to(x.dtype)
