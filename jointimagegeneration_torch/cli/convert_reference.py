"""Convert a trained reference checkpoint into a checkpoint the port reads.

    python -m jointimagegeneration_torch.cli.convert_reference model.pt out_dir/ \\
        --model-channels 128 --channel-mult 1,2,4,4,5 --num-res-blocks 2 \\
        --attention-resolutions 16,8,4 --num-head-channels 32

Counterpart of `scripts/convert_reference_checkpoint.py`, with its flags.  It
takes a torch checkpoint holding a guided-diffusion UNet — a ccdm ignite
checkpoint (`{'model': ..., 'average_model': <bare UNet state dict>}`), an LDM
Lightning checkpoint (`state_dict` with `model.diffusion_model.*` keys) or a
bare UNet state dict — and writes `out_dir/0.pt`, which a `checkpoint:` key
of the port's configs reads when it names `out_dir` (`cli/common.py`
`read_port_checkpoint`).  The entry is `--entry`, else `state_dict`, else
`average_model`, else the root.  The converted weights go in as both `params`
and `ema`, as the JAX script stores both `params` and `ema_params`.

`--attention-resolutions` takes the in-model `ds` convention (what UNetModel
consumes).  `--new-attention-order` is only for checkpoints trained with
use_new_attention_order=True (the reference configs use the legacy order).

`--ae [PREFIX]` converts an AutoencoderKL / VQModel instead: a standalone AE
training checkpoint, or one embedded in an LDM checkpoint under
`first_stage_model.` / `cond_stage_model.` (detected when PREFIX is omitted;
a checkpoint that embeds more than one AE must name it).  The result is what
`first_stage.checkpoint` / `cond_stage.checkpoint` read
(`cli/common.py` `load_ae_weights`).  The `_ae` recipe is three runs:
`--ae first_stage_model.`, `--ae cond_stage_model.`, and a plain UNet
conversion of the same checkpoint.

The `torch.load` rule: the file is read with `weights_only=True`, which
unpickles tensors, containers and numbers but runs no code from the file.
A Lightning checkpoint whose `hyper_parameters` hold plain dicts loads so; one
that pickles another object (an OmegaConf DictConfig, an argparse Namespace)
is refused, and the error names the global that failed and the flag
`--unsafe-load`, which loads with `weights_only=False` as the JAX script does
— and so runs whatever code the file holds: use it only on a file you trust.

The conversion is numpy on the host; it touches no device.
"""

from __future__ import annotations

import argparse
import pickle
import re
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..core.checkpoint import CheckpointManager
from ..utils.torch_convert import ae_state_dict_from_reference, unet_state_dict_from_reference

__all__ = ["load_reference", "reference_state_dict", "main"]


def load_reference(path, unsafe_load: bool = False) -> Any:
    """The checkpoint file at `path`, read on the CPU with
    `weights_only=True`, or with `weights_only=False` under `unsafe_load`
    (printing a warning).  A file that `weights_only` refuses raises
    ValueError naming the global that failed and `--unsafe-load`."""
    if unsafe_load:
        print(f"WARNING: --unsafe-load: unpickling {path} with weights_only=False runs any code the file holds")
        return torch.load(path, map_location="cpu", weights_only=False)
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        found = re.search(r"GLOBAL (\S+)", str(e))
        what = found.group(1) if found else "an object that is not a tensor, container or number"
        raise ValueError(f"{path}: torch.load(weights_only=True) refused the file at the global {what} (a pickled "
                         "object, e.g. Lightning hyper_parameters); pass --unsafe-load to load it with "
                         "weights_only=False, which runs code from the file: only for a file you trust") from e


def reference_state_dict(raw: Any, entry: Optional[str] = None) -> Dict[str, Any]:
    """The tensors of the checkpoint's state dict: `raw[entry]`, else its
    `state_dict`, else its `average_model`, else `raw` itself."""
    sd = raw
    if entry is not None:
        sd = raw[entry]
    elif isinstance(raw, dict):
        for name in ("state_dict", "average_model"):
            if isinstance(raw.get(name), dict):
                sd = raw[name]
                print(f"using checkpoint entry {name!r}")
                break
    return {k: v for k, v in sd.items() if hasattr(v, "shape")}


def main(argv=None) -> Path:
    """Convert as the flags say; returns the file written."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("torch_ckpt")
    p.add_argument("out_dir")
    p.add_argument("--entry", default=None,
                   help="sub-dict to use (default: 'state_dict', then 'average_model', then the checkpoint root)")
    p.add_argument("--ae", nargs="?", const="", default=None, metavar="PREFIX",
                   help="convert an AutoencoderKL instead of a UNet; optional state-dict prefix such as "
                        "'first_stage_model.' (detected when omitted)")
    p.add_argument("--model-channels", type=int, default=None)
    p.add_argument("--channel-mult", default="1,2,4,8")
    p.add_argument("--num-res-blocks", type=int, default=2)
    p.add_argument("--attention-resolutions", default="", help="comma-separated ds values, e.g. 16,8,4")
    p.add_argument("--num-head-channels", type=int, default=-1)
    p.add_argument("--num-heads", type=int, default=1)
    p.add_argument("--new-attention-order", action="store_true")
    p.add_argument("--lenient", action="store_true", help="ignore unconsumed checkpoint keys instead of failing")
    p.add_argument("--unsafe-load", action="store_true",
                   help="torch.load with weights_only=False (runs code from the file; only for a trusted file)")
    args = p.parse_args(argv)

    sd = reference_state_dict(load_reference(args.torch_ckpt, args.unsafe_load), args.entry)
    if args.ae is not None:
        state = ae_state_dict_from_reference(sd, prefix=args.ae or None, strict=not args.lenient)
        what = "AE"
        hint = "point the config's first_stage / cond_stage `checkpoint:` key at it"
    else:
        if args.model_channels is None:
            p.error("--model-channels is required for UNet conversion")
        state = unet_state_dict_from_reference(
            sd, model_channels=args.model_channels,
            channel_mult=tuple(int(m) for m in args.channel_mult.split(",")),
            num_res_blocks=args.num_res_blocks,
            attention_resolutions=tuple(int(a) for a in args.attention_resolutions.split(",") if a),
            num_head_channels=args.num_head_channels, num_heads=args.num_heads,
            use_new_attention_order=args.new_attention_order, strict=not args.lenient)
        what = "UNet"
        hint = "point the sample config's `checkpoint:` key at it"
    manager = CheckpointManager(args.out_dir)
    manager.save(0, {"params": state, "ema": state, "step": 0})
    n = sum(v.numel() for v in state.values())
    print(f"converted {what} ({n / 1e6:.2f}M params) -> {manager.step_path(0)}; {hint}")
    return manager.step_path(0)


if __name__ == "__main__":
    main()
