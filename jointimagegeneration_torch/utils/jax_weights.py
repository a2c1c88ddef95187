"""Weight bridge: JAX package parameter trees -> this port's state dicts.

Takes the flax tree as nested dicts of numpy arrays (optionally under a
top-level "params" key), or a flat mapping / `.npz` file whose keys are the
tree paths joined by '/'.  Layout changes:

  * conv kernels (...spatial, I, O) -> (O, I, ...spatial);
  * Dense kernels (in, out) -> Linear weights (out, in);
  * flax `GroupNorm_0` wrappers are dropped, `scale` becomes `weight`;
  * ResBlock parameters keep their flat names (`norm1_scale`, `conv1_kernel`,
    `emb_kernel`, `skip_kernel`, ...), kernels re-laid as above;
  * a stage-2 tree with a learned logvar, {"unet": <UNet tree>, "logvar":
    (T,)}, gives the UNet's keys and `logvar` as it is;
  * a text-guided stage-1 tree, {"unet": <UNet tree>, "refiner": <refiner
    tree>} (`MaskSampler.init_params` there), gives the UNet's keys and the
    refiner's as `refiner.<name>`, the names of `MaskSampler.named_parameters`;
    the transformer leaves follow the rules above (Dense kernels transposed,
    LayerNorm `scale` -> `weight`), and every `params` level is dropped.

`check_state` holds a bridged state dict against a model's parameters and
names the first leaf that is missing, extra or of another shape; it reshapes
nothing.  (A JAX stage-1 tree initialised without a context shape and without
a refiner sizes every `attn2`'s `to_k` / `to_v` from the query width through
flax's lazy shapes: such a tree fails here, at that leaf.)

`ae_state_dict_from_jax` does the same for an AutoencoderKL / VQModel tree
and for the stock VAE extras of `nn/vae.py` (only `kernel` leaves change
layout: the VQ codebook (n_embed, embed_dim) is 2-D but no Dense kernel, and
stays as it is), `lpips_state_dict_from_jax` for the LPIPS VGG16 tower
(`conv0` ... `conv12`), `vit_state_dict_from_jax` for the DINO ViT of
`nn/vit.py` (`cls_token` and `pos_embed` keep their (1, T, D) layout).

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

__all__ = ["unet_state_dict_from_jax", "ae_state_dict_from_jax", "lpips_state_dict_from_jax",
           "vit_state_dict_from_jax", "flatten_tree",
           "flat_paths", "check_state", "train_state_from_jax"]


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


def flat_paths(params: Union[Mapping, str, Path]) -> Dict[Tuple[str, ...], np.ndarray]:
    """Tree paths -> leaves, from a nested tree, a flat mapping with
    '/'-joined keys or tuple keys, or the `.npz` file of one.  Each top-level
    key is split at its '/'s on its own, so a flat stage-2 tree's `logvar`
    sits beside the UNet's 'unet/...' paths."""
    if isinstance(params, Mapping) and params and all(isinstance(k, tuple) for k in params):
        return {k: np.asarray(v) for k, v in params.items()}
    if isinstance(params, (str, Path)):
        with np.load(params) as z:
            params = {k: z[k] for k in z.files}
    # a top-level key is a '/'-joined path, one level ("logvar") or more
    return {tuple(k[0].split("/")) if len(k) == 1 else k: v for k, v in flatten_tree(params).items()}


def _state_dict(flat: Mapping[Tuple[str, ...], np.ndarray], unet: bool) -> Dict[str, torch.Tensor]:
    state = {}
    for path, arr in flat.items():
        path = [p for p in path if p not in ("GroupNorm_0", "params")]
        if unet and path[0] == "unet" and len(path) > 1:  # {"unet": ..., "logvar" | "refiner": ...}
            path = path[1:]
        leaf = path[-1]
        if leaf == "kernel" or (unet and leaf.endswith("_kernel")):
            arr = _to_torch_layout(arr)
        if leaf in ("kernel", "scale"):
            leaf = "weight"
        state[".".join(path[:-1] + [leaf])] = torch.tensor(np.asarray(arr, np.float32))
    return state


def unet_state_dict_from_jax(params: Union[Mapping, str, Path]) -> Dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) for `nn.unet.UNet.load_state_dict`."""
    return _state_dict(flat_paths(params), unet=True)


def ae_state_dict_from_jax(params: Union[Mapping, str, Path]) -> Dict[str, torch.Tensor]:
    """State dict for `models.autoencoder.AutoencoderKL` / `VQModel` from the
    flax variables of one ({"params": ...} or the bare tree)."""
    return _state_dict(flat_paths(params), unet=False)


def lpips_state_dict_from_jax(params: Union[Mapping, str, Path]) -> Dict[str, torch.Tensor]:
    """State dict for `eval.lpips.VGG16Features` from the JAX LPIPS' `params`."""
    return _state_dict(flat_paths(params), unet=False)


def vit_state_dict_from_jax(params: Union[Mapping, str, Path]) -> Dict[str, torch.Tensor]:
    """State dict for `nn.vit.ViT` from the flax variables of the JAX
    `ViTExtractor` ({"params": ...} or the bare tree)."""
    return _state_dict(flat_paths(params), unet=False)


def check_state(own: Mapping[str, torch.Tensor], state: Mapping[str, torch.Tensor], source: str) -> None:
    """Raise ValueError unless `state` holds exactly the names of `own` at
    their shapes, naming the first leaf that differs."""
    extra = sorted(set(state) - set(own))
    if extra:
        raise ValueError(f"{source} holds leaves the model lacks, e.g. {extra[:3]}")
    for name, t in own.items():
        if name not in state:
            raise ValueError(f"{source} lacks {name}")
        if tuple(state[name].shape) != tuple(t.shape):
            hint = ""
            if ".attn2.to_k." in name or ".attn2.to_v." in name:
                hint = (" (a JAX tree initialised without a context shape sizes attn2's to_k / to_v from the "
                        "query width; initialise it with the context's shape)")
            raise ValueError(f"{source} leaf {name} has shape {tuple(state[name].shape)}, the model "
                             f"{tuple(t.shape)}{hint}")


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
