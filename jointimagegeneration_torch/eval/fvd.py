"""FVD (Frechet Video Distance) over CT volumes.

Counterpart of `jointimagegeneration_tpu/eval/fvd.py`: the Frechet distance
(`eval.metrics.frechet_distance`) between per-volume feature vectors of the
real and the generated set, from a pluggable (D, H, W) -> (F,) extractor:
  * `i3d_npz_feature_fn(path)`: the port's I3D (`eval/i3d.py`) with the
    weights of a converted `.npz` (`cli/convert_i3d.py`), on the device given;
  * `i3d_feature_fn(path)`: a torchscript I3D model (`torch.jit.load`);
  * `downsample_feature_fn` (the default, needs no weights): statistics of a
    3-level spatial pyramid; not calibrated to the published FVD scale, but a
    valid Frechet metric for comparing runs.
A volume in [0, 1] enters the I3D as (1, D, H, W, 3) in [-1, 1], the depth as
time, and leaves as its 400 time-averaged logits.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.runtime import resolve_device
from .metrics import frechet_distance

__all__ = ["fvd", "downsample_feature_fn", "i3d_feature_fn", "i3d_npz_feature_fn"]


def downsample_feature_fn(vol: np.ndarray, levels: int = 3) -> np.ndarray:
    """(D, H, W) -> (F,) pyramid statistics, of one length for any size: per
    level the mean, the std and the three per-axis mean profiles at 8 taps;
    the pyramid stops halving once an axis would vanish (a depth-3 volume)."""
    feats = []
    v = np.asarray(vol, np.float32)

    def profile(x: np.ndarray) -> np.ndarray:  # a 1-D profile at 8 taps
        return x[np.linspace(0, len(x) - 1, 8).round().astype(int)]

    for _ in range(levels):
        feats.extend([v.mean(), v.std()])
        feats.extend(profile(v.mean(axis=(1, 2))))
        feats.extend(profile(v.mean(axis=(0, 2))))
        feats.extend(profile(v.mean(axis=(0, 1))))
        if min(v.shape) >= 2:
            v = v[: v.shape[0] // 2 * 2, : v.shape[1] // 2 * 2, : v.shape[2] // 2 * 2]
            v = v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2, v.shape[2] // 2, 2).mean((1, 3, 5))
    return np.asarray(feats, np.float32)


def i3d_feature_fn(checkpoint_path: str, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """A (D, H, W) -> (F,) extractor from a torchscript I3D model, which takes
    (1, 3, D, H, W) in [-1, 1]; on CUDA unless `device` says otherwise."""
    device = resolve_device(device)
    model = torch.jit.load(checkpoint_path, map_location=device).eval()

    def fn(vol: np.ndarray) -> np.ndarray:
        v = torch.from_numpy(np.asarray(vol, np.float32)).to(device)
        v = v[None, None].repeat(1, 3, 1, 1, 1) * 2 - 1
        with torch.no_grad():
            return model(v).float().cpu().numpy().reshape(-1)

    return fn


def i3d_npz_feature_fn(npz_path: str, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """A (D, H, W) -> (400,) extractor: the port's I3D with the weights of a
    converted `.npz`, on CUDA unless `device` says otherwise."""
    from .i3d import i3d_features, load_i3d_npz

    device = resolve_device(device)
    params = load_i3d_npz(npz_path, device)

    def fn(vol: np.ndarray) -> np.ndarray:
        v = torch.from_numpy(np.asarray(vol, np.float32)).to(device)
        with torch.no_grad():
            return i3d_features(params, v[None, ..., None].expand(-1, -1, -1, -1, 3) * 2.0 - 1.0).cpu().numpy()[0]

    return fn


def fvd(real_volumes: Sequence[np.ndarray], generated_volumes: Sequence[np.ndarray],
        feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None) -> float:
    feature_fn = feature_fn or downsample_feature_fn
    fa = np.stack([feature_fn(v) for v in real_volumes])
    fb = np.stack([feature_fn(v) for v in generated_volumes])
    return frechet_distance(fa, fb)
