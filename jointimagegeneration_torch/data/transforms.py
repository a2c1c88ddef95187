"""Host-side volume transforms (numpy).

The port's copies of `jointimagegeneration_tpu/data/transforms.py`:
`window_norm` (CT windowing), `resize_volume`, `crop_or_pad` (torchio's
CropOrPad: a centred crop or pad), `random_flip` and `one_hot_np`.  The JAX
package's datasets take a native C `window_norm` when
`native/libjig_native.so` is built; the port always takes this numpy one.

`resize_volume` computes what `jax.image.resize` computes, without JAX: per
resized axis a (in, out) weight matrix as `jax.image.scale_and_translate`
builds it (sample centres at (i + 0.5) * in / out - 0.5, the triangle or
Keys cubic kernel widened by in / out when downsampling, so it antialiases,
each column normalised), contracted axis by axis in float32; `nearest` takes
the input index floor((i + 0.5) * in / out) in float32 arithmetic, as
`jax.image.resize` does, which at non-integer ratios is
`F.interpolate(mode="nearest-exact")`, not `mode="nearest"`.  Both divide by
a constant as XLA compiles it, as a multiply by the float32 reciprocal: where
(i + 0.5) * in / out is a whole number and out is no power of 2 the product
can fall an ulp short of it, and the index one below (20 -> 25: input 1 for
output 2, not 2).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["window_norm", "resize_volume", "crop_or_pad", "random_flip", "one_hot_np"]


def window_norm(image: np.ndarray, window_pos: float = 60.0, window_width: float = 360.0) -> np.ndarray:
    """Clamp a HU image into [0, 1] over [L - W/2, L + W/2] (CT windowing,
    default W = 360, L = 60)."""
    lo = window_pos - window_width / 2
    out = (image.astype(np.float32) - lo) / window_width
    return np.clip(out, 0.0, 1.0)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4)) * x + np.float32(2)
    out = np.where(x >= 1, far, out)
    return np.where(x >= 2, np.float32(0), out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def _reciprocal(x: float) -> np.float32:
    return np.float32(1) / np.float32(x)


def _weight_matrix(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float32 resampling weights (jax.image's
    compute_weight_mat with antialiasing, translation 0)."""
    inv_scale = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale) - np.float32(0.5)
    # XLA divides by the constant kernel scale as a multiply by its float32 reciprocal
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) * _reciprocal(max(inv_scale, 1.0))
    w = _KERNELS[method](x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """floor((i + 0.5) * in / out) as XLA computes it: the division folded
    into one float32 multiplier, in * (1 / out)."""
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * (np.float32(n_in) * _reciprocal(n_out))
    return np.minimum(np.floor(pos).astype(np.int64), n_in - 1)


def resize_volume(vol: np.ndarray, target: Sequence[int], method: str = "linear") -> np.ndarray:
    """Resize the leading axes of a (D, H, W) or (D, H, W, C) array to
    `target` (3 sizes).  'nearest' keeps the dtype (labels); 'linear' and
    'cubic' return float32."""
    if method not in ("nearest", "linear", "cubic"):
        raise KeyError(method)
    target = tuple(int(t) for t in target)
    out = np.asarray(vol) if method == "nearest" else np.asarray(vol, np.float32)
    # shrinking axes first keeps the later contractions small
    axes = sorted((ax for ax, t in enumerate(target) if out.shape[ax] != t), key=lambda ax: target[ax] / out.shape[ax])
    for ax in axes:
        n_in, n_out = out.shape[ax], target[ax]
        if method == "nearest":
            out = np.take(out, _nearest_index(n_in, n_out), axis=ax)
        else:
            moved = np.moveaxis(out, ax, -1)
            out = np.moveaxis(moved @ _weight_matrix(n_in, n_out, method), -1, ax)
    return np.ascontiguousarray(out)


def crop_or_pad(vol: np.ndarray, target: Sequence[int], pad_value: float = 0.0) -> np.ndarray:
    """Centred crop or pad of the leading len(target) axes (the extra voxel of
    an odd difference after, when padding; the crop starts at (s - t) // 2)."""
    out = vol
    for ax, t in enumerate(target):
        s = out.shape[ax]
        if s > t:
            start = (s - t) // 2
            out = out[(slice(None),) * ax + (slice(start, start + t),)]
        elif s < t:
            pad = [(0, 0)] * out.ndim
            pad[ax] = ((t - s) // 2, t - s - (t - s) // 2)
            out = np.pad(out, pad, constant_values=pad_value)
    return out


def random_flip(rng: np.random.Generator, *arrays: np.ndarray, axis: int = -1, p: float = 0.5):
    """Flip every array along `axis` together with probability p (one draw)."""
    if rng.random() < p:
        return tuple(np.flip(a, axis=axis).copy() for a in arrays)
    return arrays


def one_hot_np(labels: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    """(...,) int -> (..., C) one-hot, trailing class axis (labels clipped
    into [0, C))."""
    return np.eye(num_classes, dtype=dtype)[np.clip(labels, 0, num_classes - 1)]
