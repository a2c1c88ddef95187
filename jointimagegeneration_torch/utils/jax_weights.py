"""Weight bridge: a JAX package UNet parameter tree -> this port's UNet state dict.

Takes the flax tree as nested dicts of numpy arrays (optionally under a
top-level "params" key), or a flat mapping / `.npz` file whose keys are the
tree paths joined by '/'.  Layout changes:

  * conv kernels (...spatial, I, O) -> (O, I, ...spatial);
  * Dense kernels (in, out) -> Linear weights (out, in);
  * flax `GroupNorm_0` wrappers are dropped, `scale` becomes `weight`;
  * ResBlock parameters keep their flat names (`norm1_scale`, `conv1_kernel`,
    `emb_kernel`, `skip_kernel`, ...), kernels re-laid as above;
  * a stage-2 tree with a learned logvar, {"unet": <UNet tree>, "logvar":
    (T,)}, gives the UNet's keys and `logvar` as it is.

`train_state_from_jax` carries a whole JAX train state (params, EMA, an
optax Adam / AdamW state, optionally inside optax.MultiSteps) over as an
`EMATrainState.state_dict()`, so a run started in the JAX package can
continue in the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["unet_state_dict_from_jax", "flatten_tree", "train_state_from_jax"]


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
        if path[0] == "unet" and len(path) > 1:  # {"unet": ..., "logvar": ...}
            path = path[1:]
        if path[0] == "params":
            path = path[1:]
        leaf = path[-1]
        if leaf == "kernel" or leaf.endswith("_kernel"):
            arr = _to_torch_layout(arr)
        if leaf in ("kernel", "scale"):
            leaf = "weight"
        state[".".join(path[:-1] + [leaf])] = torch.tensor(np.asarray(arr, np.float32))
    return state


def _find_states(tree: Any, field: str) -> list:
    """Every namedtuple in an optax state tree that has `field`, in order."""
    if hasattr(tree, "_fields"):
        found = [tree] if field in tree._fields else []
        return found + [s for x in tree for s in _find_states(x, field)]
    if isinstance(tree, (tuple, list)):
        return [s for x in tree for s in _find_states(x, field)]
    return []


def train_state_from_jax(params: Mapping, ema_params: Mapping, opt_state: Any, step: Optional[int] = None,
                         nonfinite_count: int = 0) -> Dict:
    """An `EMATrainState.state_dict()` from numpy trees as
    `jax.device_get(EMATrainState)` gives them: its `params`, `ema_params`
    and the `opt_state` of the JAX package's Adam / AdamW chain (optionally
    behind clip_by_global_norm, optionally inside optax.MultiSteps).  Adam's
    mu / nu / count become torch's exp_avg / exp_avg_sq / step (the UNet
    bridge's layout transposes applied), the schedule's count the port
    optimizer's `count`, and MultiSteps' mini_step / acc_grads its
    accumulation.  `step` defaults to that count."""
    adam = _find_states(opt_state, "mu")
    if len(adam) != 1:
        raise ValueError("train_state_from_jax carries an Adam / AdamW optax state (one "
                         f"ScaleByAdamState); found {len(adam)}")
    adam = adam[0]
    schedule = [s for s in _find_states(opt_state, "count") if "mu" not in s._fields]
    count = int(np.asarray(schedule[0].count if schedule else adam.count))
    mu, nu = unet_state_dict_from_jax(adam.mu), unet_state_dict_from_jax(adam.nu)
    adam_step = torch.tensor(float(np.asarray(adam.count)))
    optimizer = {"count": count,
                 "state": {n: {"step": adam_step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]} for n in mu}}
    for multi in _find_states(opt_state, "mini_step"):
        optimizer["mini_step"] = int(np.asarray(multi.mini_step))
        optimizer["acc_grads"] = unet_state_dict_from_jax(multi.acc_grads)
    return {
        "params": unet_state_dict_from_jax(params),
        "ema": unet_state_dict_from_jax(ema_params),
        "optimizer": optimizer,
        "step": count if step is None else int(step),
        "nonfinite_count": int(nonfinite_count),
    }
