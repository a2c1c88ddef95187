"""Host-side image transforms (numpy).

A copy of `window_norm` from `jointimagegeneration_tpu/data/transforms.py`.
The JAX package's datasets take a native C route for it when
`native/libjig_native.so` is built; the port always takes this numpy one.
"""

from __future__ import annotations

import numpy as np

__all__ = ["window_norm"]


def window_norm(image: np.ndarray, window_pos: float = 60.0, window_width: float = 360.0) -> np.ndarray:
    """Clamp a HU image into [0, 1] over [L - W/2, L + W/2] (CT windowing,
    default W = 360, L = 60)."""
    lo = window_pos - window_width / 2
    out = (image.astype(np.float32) - lo) / window_width
    return np.clip(out, 0.0, 1.0)
