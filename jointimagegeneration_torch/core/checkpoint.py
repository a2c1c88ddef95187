"""Checkpoints as `torch.save` files, with the JAX package's retention policies.

Counterpart of `jointimagegeneration_tpu/core/checkpoint.py` (which writes
orbax trees; the port neither reads nor writes those).  Under `directory`:

  * `<step>.pt` — rolling saves (score-less), the newest `max_to_keep` kept;
  * `best/<step>.pt` — scored saves; the `best_k` best by score (`best_mode`
    max or min) kept, scores in `best/scores.json`;
  * `trainstep/<step>.pt` — weight-only snapshots (`save_weights`), all kept.

Each file is written to a temporary name in its directory and renamed into
place (`os.replace`), so a crash mid-write never leaves a partial checkpoint
under a step's name.  `restore` loads with `weights_only=True`.

`load_partial` is the warm-start surgery of the JAX package's function of
that name (the reference's `init_from_ckpt`): the weights of a port
checkpoint (a directory of `<step>.pt` files or one `.pt`) or of a JAX
`.npz` (through `utils.jax_weights`) mapped non-strictly onto a template
state dict by name and shape.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import torch

__all__ = ["CheckpointManager", "load_partial", "NON_MODEL_PREFIXES"]

# leaves beside the UNet's in a train state's parameters (`MaskSampler` /
# `SliceLDM.named_parameters`): `only_model` leaves them at their fresh init
NON_MODEL_PREFIXES = ("refiner.", "logvar")
# the JAX package's source names and the keys a port checkpoint keeps them under
_PORT_KEYS = {"params": "params", "ema_params": "ema", "ema": "ema", "g_params": "g_params"}


def _atomic_save(obj: Any, path: Path) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _steps(directory: Path) -> List[int]:
    return sorted(int(p.stem) for p in directory.glob("*.pt") if p.stem.isdigit())


class CheckpointManager:
    def __init__(self, directory, max_to_keep: int = 3, best_mode: str = "max", best_k: int = 1):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_mode = best_mode
        self.best_k = best_k

    @property
    def _best_dir(self) -> Path:
        return self.directory / "best"

    def _scores(self) -> Dict[int, float]:
        f = self._best_dir / "scores.json"
        return {int(k): v for k, v in json.loads(f.read_text()).items()} if f.exists() else {}

    def save(self, step: int, state: Any, score: Optional[float] = None) -> None:
        """Score-less saves roll (FIFO `max_to_keep`); scored saves compete in
        the best-k tree.  A step that belongs in both is saved by two calls."""
        if score is None:
            _atomic_save(state, self.directory / f"{step}.pt")
            for old in _steps(self.directory)[:-self.max_to_keep]:
                (self.directory / f"{old}.pt").unlink()
            return
        self._best_dir.mkdir(exist_ok=True)
        scores = self._scores()
        scores[int(step)] = float(score)
        ranked = sorted(scores, key=lambda s: scores[s], reverse=self.best_mode == "max")
        keep = set(ranked[:self.best_k])
        if step in keep:
            _atomic_save(state, self._best_dir / f"{step}.pt")
        tmp = self._best_dir / f".scores.json.{os.getpid()}.tmp"
        tmp.write_text(json.dumps({str(s): scores[s] for s in sorted(keep)}))
        os.replace(tmp, self._best_dir / "scores.json")
        for old in _steps(self._best_dir):
            if old not in keep:
                (self._best_dir / f"{old}.pt").unlink()

    def save_weights(self, step: int, weights: Any) -> None:
        """Weight-only snapshot under `trainstep/`, never pruned."""
        d = self.directory / "trainstep"
        d.mkdir(exist_ok=True)
        _atomic_save(weights, d / f"{step}.pt")

    def all_steps(self) -> Dict[str, List[int]]:
        """{'rolling': [...], 'best': [...], 'trainstep': [...]} retained steps."""
        sub = lambda name: _steps(self.directory / name) if (self.directory / name).exists() else []
        return {"rolling": _steps(self.directory), "best": sub("best"), "trainstep": sub("trainstep")}

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        found = steps["rolling"] + steps["best"]
        return max(found) if found else None

    def best_step(self) -> Optional[int]:
        scores = self._scores()
        if not scores:
            return None
        return (max if self.best_mode == "max" else min)(scores, key=lambda s: scores[s])

    def step_path(self, step: Optional[int] = None) -> Path:
        """The file of `step` (default: the latest), rolling before best."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        for path in (self.directory / f"{step}.pt", self._best_dir / f"{step}.pt"):
            if path.exists():
                return path
        raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")

    def restore(self, step: Optional[int] = None) -> Any:
        """The saved object at `step` (default: the latest), on the CPU."""
        return torch.load(self.step_path(step), map_location="cpu", weights_only=True)


def _source_weights(path, source: str, bridge: Optional[Callable]):
    """(name -> tensor, {name: the leaf's JAX path or None}, the key read)
    of the checkpoint at `path`; falls back across params / ema_params /
    g_params as the JAX function does."""
    from ..utils.jax_weights import flat_paths, unet_state_dict_from_jax

    p = Path(path)
    order = [source] + [k for k in ("params", "ema_params", "g_params") if k != source]
    if p.suffix == ".npz" and p.is_file():
        flat = flat_paths(p)
        tops = {k[0] for k in flat}
        key = next((k for k in order if k in tops), None)
        if key is None and tops & {"ema", "opt_state", "step"}:
            raise KeyError(f"checkpoint at {str(path)!r} has none of params/ema_params/g_params "
                           f"(top-level keys: {sorted(tops)[:8]})")
        tree = {k[1:]: v for k, v in flat.items() if k[0] == key} if key else flat  # a bare params tree
        state = (bridge or unet_state_dict_from_jax)(tree)
        # each bridged name's JAX path, for ignore keys written as JAX paths
        paths = {}
        for k in tree:
            try:
                one = (bridge or unet_state_dict_from_jax)({k: tree[k]})
            except Exception:  # a leaf that only bridges with its siblings (the round-1 layout)
                continue
            paths.update({name: "/".join(k) for name in one})
        return state, paths, key or "params"
    if p.is_dir():
        manager = CheckpointManager(p)
        if manager.latest_step() is None:
            raise ValueError(f"init_from {str(path)!r} is a directory with no <step>.pt")
        p = manager.step_path()
    elif not (p.is_file() and p.suffix == ".pt"):
        raise ValueError(f"init_from {str(path)!r}: unsupported checkpoint format (expected a port checkpoint "
                         "directory of <step>.pt files, one such .pt file, or a JAX .npz; orbax directories and "
                         "other files are not read)")
    raw = torch.load(p, map_location="cpu", weights_only=True)
    for key in order:
        if isinstance(raw, dict) and isinstance(raw.get(_PORT_KEYS.get(key, key)), dict):
            return dict(raw[_PORT_KEYS.get(key, key)]), {}, key
    raise KeyError(f"checkpoint at {str(path)!r} has none of params/ema_params/g_params "
                   f"(top-level keys: {list(raw)[:8] if isinstance(raw, dict) else type(raw)})")


def load_partial(template: Mapping[str, torch.Tensor], path, ignore_keys: Sequence[str] = (),
                 only_model: bool = False, source: str = "params", bridge: Optional[Callable] = None,
                 verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Map the weights of the checkpoint at `path` onto `template` (name ->
    tensor, e.g. a model's `named_parameters()`), non-strictly; returns the
    merged name -> tensor dict (template tensors where nothing loads).

      * `source` ('params', 'ema_params' / 'ema', 'g_params') is read, else
        the first of params, ema_params, g_params the file holds (a note is
        printed); a JAX `.npz` without such a top-level key is a bare params
        tree, bridged by `bridge` (`unet_state_dict_from_jax` by default);
      * every leaf whose path starts with an `ignore_keys` prefix is dropped
        (printed).  Prefixes may be dotted or '/'-joined; a leaf matches by
        its port name, by the name under a synthetic 'unet/' (a UNet leaf),
        or, from an `.npz`, by its JAX path in the file (the natural path of
        a bare tree).  A prefix that matches nothing is warned about;
      * the leaves in both with equal shapes load; template leaves with no
        source keep their values; source-only and shape-mismatched leaves are
        dropped and counted, as torch's strict=False load reports them;
      * `only_model` loads only the UNet's leaves (not `refiner.*`,
        `logvar`)."""
    source = "ema_params" if source == "ema" else source
    src, jax_paths, key = _source_weights(path, source, bridge)
    if verbose and key != source:
        print(f"init_from: no '{source}' in checkpoint — using '{key}'")
    norm = lambda k: k.replace(".", "/")
    ignore = tuple(norm(k) for k in ignore_keys)
    matched = {k: 0 for k in ignore}
    for name in list(src):
        views = [norm(name)]
        if not name.startswith(NON_MODEL_PREFIXES):
            views.append("unet/" + norm(name))
        if jax_paths.get(name):
            views.append(jax_paths[name])
        hits = [k for k in ignore if any(v.startswith(k) for v in views)]
        if hits:
            for k in hits:
                matched[k] += 1
            if verbose:
                print(f"init_from: deleting key {name} from checkpoint")
            del src[name]
    for k, n in matched.items():
        if n == 0 and verbose:
            print(f"init_from: WARNING — ignore key {k!r} matched no checkpoint leaves")
    merged, loaded, mismatched = dict(template), 0, []
    for name, v in src.items():
        if name not in template or (only_model and name.startswith(NON_MODEL_PREFIXES)):
            continue
        if tuple(v.shape) != tuple(template[name].shape):
            mismatched.append(name)
            continue
        merged[name] = v
        loaded += 1
    missing = [k for k in template if k not in src]
    unexpected = [k for k in src if k not in template]
    if verbose:
        print(f"init_from: restored {loaded}/{len(template)} leaves from {path} ({len(missing)} missing, "
              f"{len(unexpected)} unexpected, {len(mismatched)} shape-mismatched)")
        for what, keys in (("missing", missing), ("unexpected", unexpected), ("shape-mismatched", mismatched)):
            if keys:
                print(f"init_from: {what} keys: {keys[:10]}{' …' if len(keys) > 10 else ''}")
    return merged
