"""Weight bridge: a JAX package UNet parameter tree -> this port's UNet state dict.

Takes the flax tree as nested dicts of numpy arrays (optionally under a
top-level "params" key), or a flat mapping / `.npz` file whose keys are the
tree paths joined by '/'.  Layout changes:

  * conv kernels (...spatial, I, O) -> (O, I, ...spatial);
  * Dense kernels (in, out) -> Linear weights (out, in);
  * flax `GroupNorm_0` wrappers are dropped, `scale` becomes `weight`;
  * ResBlock parameters keep their flat names (`norm1_scale`, `conv1_kernel`,
    `emb_kernel`, `skip_kernel`, ...), kernels re-laid as above.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

__all__ = ["unet_state_dict_from_jax", "flatten_tree"]


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:  # Dense (in, out)
        return arr.T
    if arr.ndim > 2:  # conv (...spatial, I, O)
        n = arr.ndim
        return np.transpose(arr, (n - 1, n - 2, *range(n - 2)))
    return arr


def unet_state_dict_from_jax(params: Union[Mapping, str, Path]) -> Dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) for `nn.unet.UNet.load_state_dict`."""
    if isinstance(params, (str, Path)):
        with np.load(params) as z:
            params = {k: z[k] for k in z.files}
    flat = flatten_tree(params)
    if flat and all(len(k) == 1 and "/" in k[0] for k in flat):
        flat = {tuple(k[0].split("/")): v for k, v in flat.items()}
    state = {}
    for path, arr in flat.items():
        path = [p for p in path if p != "GroupNorm_0"]
        if path[0] == "params":
            path = path[1:]
        leaf = path[-1]
        if leaf == "kernel" or leaf.endswith("_kernel"):
            arr = _to_torch_layout(arr)
        if leaf in ("kernel", "scale"):
            leaf = "weight"
        state[".".join(path[:-1] + [leaf])] = torch.tensor(np.asarray(arr, np.float32))
    return state
