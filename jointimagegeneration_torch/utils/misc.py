"""Host seeding, code self-archival, parameter counting, the legacy ResBlock layout.

Counterpart of `jointimagegeneration_tpu/utils/misc.py`:
  * `set_host_seeds`: Python's, numpy's and torch's host generators and
    PYTHONHASHSEED (the port's device draws come from `diffusion.noise`);
  * `archive_code`: `<out_dir>/code.tar.gz` of the files `git ls-files`
    lists under the repo root (every `*.py` where git is missing or fails);
  * `count_params`: the elements of a module's parameters or of an iterable
    of tensors (or of a nested dict of arrays);
  * `convert_legacy_resblock_params`: a round-1 JAX tree whose ResBlocks
    are nested submodules (in_norm/GroupNorm_0, in_conv, emb_proj, out_norm,
    out_conv, skip) rewritten into the flat layout (norm1_scale,
    conv1_kernel, emb_kernel, ...) that `utils.jax_weights` reads.
"""

from __future__ import annotations

import os
import random
import subprocess
import tarfile
from pathlib import Path
from typing import Iterable, Mapping, Union

import numpy as np
import torch

__all__ = ["set_host_seeds", "archive_code", "count_params", "convert_legacy_resblock_params"]

_LEGACY = {"in_norm", "in_conv", "emb_proj", "out_norm", "out_conv"}


def set_host_seeds(seed: int = 1024) -> None:
    """Seed the host-side generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def archive_code(out_dir, repo_root=None) -> str:
    """tar.gz the tracked source into `out_dir`; returns the archive's path."""
    root = Path(repo_root or Path(__file__).resolve().parents[2])
    out = Path(out_dir) / "code.tar.gz"
    out.parent.mkdir(parents=True, exist_ok=True)
    try:
        files = subprocess.run(["git", "ls-files"], cwd=root, capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except Exception:
        files = [str(p.relative_to(root)) for p in root.rglob("*.py")]
    with tarfile.open(out, "w:gz") as tar:
        for f in files:
            p = root / f
            if p.exists():
                tar.add(p, arcname=f)
    return str(out)


def count_params(params: Union[torch.nn.Module, Iterable, Mapping]) -> int:
    """Elements of every parameter (module), tensor (iterable) or leaf array
    (nested mapping)."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    if isinstance(params, Mapping):
        return sum(count_params(v) if isinstance(v, Mapping) else int(np.prod(np.shape(v)))
                   for v in params.values())
    return sum(int(np.prod(tuple(p.shape))) for p in params)


def convert_legacy_resblock_params(tree):
    """The round-1 ResBlock layout -> the flat one; other subtrees as they are."""

    def walk(node):
        if not isinstance(node, Mapping):
            return node
        if _LEGACY.issubset(node.keys()):
            out = {k: walk(v) for k, v in node.items() if k not in _LEGACY and k != "skip"}
            out["norm1_scale"] = node["in_norm"]["GroupNorm_0"]["scale"]
            out["norm1_bias"] = node["in_norm"]["GroupNorm_0"]["bias"]
            out["conv1_kernel"] = node["in_conv"]["kernel"]
            out["conv1_bias"] = node["in_conv"]["bias"]
            out["emb_kernel"] = node["emb_proj"]["kernel"]
            out["emb_bias"] = node["emb_proj"]["bias"]
            out["norm2_scale"] = node["out_norm"]["GroupNorm_0"]["scale"]
            out["norm2_bias"] = node["out_norm"]["GroupNorm_0"]["bias"]
            out["conv2_kernel"] = node["out_conv"]["kernel"]
            out["conv2_bias"] = node["out_conv"]["bias"]
            if "skip" in node:
                out["skip_kernel"] = node["skip"]["kernel"]
                out["skip_bias"] = node["skip"]["bias"]
            return out
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)
