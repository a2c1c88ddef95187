"""Convert a torch I3D checkpoint into the `.npz` that `eval/i3d.py` loads.

    python -m jointimagegeneration_torch.cli.convert_i3d --i3d rgb_i3d.pt --out i3d.npz

The counterpart of the JAX package's `scripts/convert_i3d_weights.py`, with its
flags and its `.npz` keys (`<unit>/kernel` DHWIO, `<unit>/scale`,
`<unit>/bias`, the BatchNorm folded in, inference only), so a file written by
either loads in both packages.  The checkpoint is a torchscript file (read by
`torch.jit.load`) or a state dict in the standard `<Unit>.conv3d.weight` /
`<Unit>.bn.*` naming, read with `torch.load(weights_only=True)`: tensors and
containers only, no code runs.  Use it as `cli.sample`'s `i3d_weights`.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..eval.i3d import parse_torch_i3d_sd

__all__ = ["load_torch_sd", "convert", "main"]


def load_torch_sd(path) -> Dict[str, torch.Tensor]:
    """The state dict of a torchscript I3D or of a saved state dict (under
    `state_dict` when it is wrapped)."""
    try:
        return dict(torch.jit.load(str(path), map_location="cpu").state_dict())
    except RuntimeError:  # not a torchscript archive
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return obj


def convert(i3d_path, out_path) -> int:
    """Write the `.npz` of `i3d_path` to `out_path`; returns the unit count."""
    units = parse_torch_i3d_sd(load_torch_sd(i3d_path))
    if not units:
        raise SystemExit("no `<unit>.conv3d.weight` tensors found: unrecognised checkpoint layout")
    np.savez(out_path, **{f"{unit}/{leaf}": arr for unit, leaves in units.items() for leaf, arr in leaves.items()})
    return len(units)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--i3d", required=True, help="torch I3D checkpoint (.pt/.pth, torchscript or state dict)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    n = convert(Path(args.i3d), args.out)
    print(f"converted {n} I3D units -> {args.out}")


if __name__ == "__main__":
    main()
