"""Shared by the CLIs: the first-stage autoencoders, their weights,
the latent (`_ae`) stage 2 and the slice dataset.

Counterpart of the AE part of `jointimagegeneration_tpu/cli/common.py`
(`build_autoencoder`, `load_ae_params`, `build_latent_ldm`,
`build_slice_dataset`).  The card's machine has no orbax, so AE weights come
from a flat `.npz` of the JAX AE variables ('/'-joined keys, as the UNet
bridge reads them): a `cli.train_ae` state keeps them under `g_params`, a
converted reference AE under `params`.

The latent scale factor comes from `first_stage.scale_factor`, else from
`latent_scale.json` in the directory of the UNet's `.npz` (the JAX CLI reads
it in the UNet's checkpoint directory, which is that directory's
counterpart), else 1.0.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch import nn

from ..data.datasets import SyntheticSliceDataset
from ..models.autoencoder import AutoencoderKL, VQModel
from ..nn.unet import ZERO_INIT_SUFFIXES
from ..utils.jax_weights import ae_state_dict_from_jax, flat_paths

__all__ = ["build_autoencoder", "load_ae_weights", "build_latent_ldm", "build_slice_dataset",
           "fill_zero_init", "LATENT_SCALE_FILE"]

LATENT_SCALE_FILE = "latent_scale.json"


def fill_zero_init(module: nn.Module, std: float, seed: int) -> None:
    """Fill the zero-initialised kernels of a fresh module (the UNet's conv2,
    proj_out and out_conv, the AEs' proj_out) with N(0, std^2) drawn from
    `seed`, so that a random smoke network carries signal through them."""
    device = next(module.parameters()).device
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(ZERO_INIT_SUFFIXES):
                p.normal_(0.0, float(std), generator=g)


def build_autoencoder(m: dict, device, seed: int = 3) -> nn.Module:
    """An AE from a model-config section (`embed_dim` and the reference's
    `ddconfig` keys); `type: vq` builds the VQ model.  `seed` seeds its fresh
    init."""
    dd = m.get("ddconfig", {})
    kw = dict(embed_dim=m.get("embed_dim", 4), ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
              num_res_blocks=dd.get("num_res_blocks", 2), attn_resolutions=tuple(dd.get("attn_resolutions", ())),
              z_channels=dd.get("z_channels", 4), in_channels=dd.get("in_channels", 1), out_ch=dd.get("out_ch", 1),
              dims=dd.get("dims", 2), resolution=dd.get("resolution", 512),
              attn_type="linear" if dd.get("use_linear_attn") else dd.get("attn_type", "vanilla"),
              device=device, seed=seed)
    if m.get("type", "kl") == "vq":
        return VQModel(n_embed=m.get("n_embed", 8192), **kw)
    return AutoencoderKL(**kw)


def load_ae_weights(module: nn.Module, section: Optional[dict], fresh_init_noise: float = 0.0,
                    seed: int = 0) -> None:
    """Load `section['checkpoint']` (a flat `.npz` of the JAX AE variables,
    under `g_params` or `params`) into `module`, every leaf's shape checked;
    without a checkpoint keep the fresh init, say so, and fill its zero-init
    kernels with N(0, fresh_init_noise^2) drawn from `seed`."""
    ck = (section or {}).get("checkpoint")
    if not ck:
        print("WARNING: no AE checkpoint configured — using FRESH-INIT (random) first-stage weights")
        if fresh_init_noise:
            fill_zero_init(module, fresh_init_noise, seed)
        return
    if not str(ck).endswith(".npz") or not Path(ck).is_file():
        raise ValueError(f"AE checkpoint {ck!r}: the PyTorch sampler reads a flat .npz of the JAX AE variables")
    flat = flat_paths(ck)
    for top in ("g_params", "params"):
        tree = {k[1:] if top == "g_params" else k: v for k, v in flat.items() if k[0] == top}
        if tree:
            break
    else:
        raise ValueError(f"AE checkpoint {ck!r} has neither 'g_params' (cli.train_ae) nor 'params' (a converted "
                         f"AE); top-level keys: {sorted({k[0] for k in flat})[:6]}")
    state = ae_state_dict_from_jax(tree)
    own = module.state_dict()
    extra = sorted(set(state) - set(own))
    if extra:
        raise ValueError(f"AE checkpoint {ck!r} holds leaves the model lacks, e.g. {extra[:3]} (wrong ddconfig?)")
    for name, t in own.items():
        if name not in state:
            raise ValueError(f"AE checkpoint {ck!r} lacks {name} (wrong ddconfig?)")
        if tuple(state[name].shape) != tuple(t.shape):
            raise ValueError(f"AE checkpoint leaf {name} shape {tuple(state[name].shape)} != model "
                             f"{tuple(t.shape)} (wrong ddconfig for {ck}?)")
    module.load_state_dict(state)


def build_latent_ldm(s2: dict, inner, size: int, device, fresh_init_noise: float = 0.0, seed: int = 0
                     ) -> Tuple[Optional[object], int]:
    """The latent route from a stage-2 section: the frozen AEs with their
    weights and the scale factor around the pixel-space SliceLDM `inner`.
    Returns (LatentSliceLDM, latent size size // f), or (None, size) when
    `s2` has no first_stage.  Raises when the cond encoder (the cond stage,
    or else the first stage) does not take the [prev slice, mask] pair of
    out_ch + 1 channels."""
    fs_cfg = s2.get("first_stage")
    if not fs_cfg:
        return None, size
    from ..models.latent_ldm import LatentSliceLDM

    cs_cfg = s2.get("cond_stage")
    in_ch = (cs_cfg or fs_cfg).get("ddconfig", {}).get("in_channels", 1)
    need = fs_cfg.get("ddconfig", {}).get("out_ch", 1) + 1
    if in_ch != need:  # checked before the AEs are built
        which = "cond_stage" if cs_cfg else "first_stage (used as cond encoder — add a cond_stage section)"
        raise ValueError(f"latent cond encoder ({which}) has in_channels={in_ch} but the "
                         f"[prev slice, mask] condition is {need}-channel")
    ae = build_autoencoder(fs_cfg, device, seed=3)
    cond_ae = build_autoencoder(cs_cfg, device, seed=5) if cs_cfg else None
    load_ae_weights(ae, fs_cfg, fresh_init_noise, seed)
    if cond_ae is not None:
        load_ae_weights(cond_ae, cs_cfg, fresh_init_noise, seed + 1)
    sf = fs_cfg.get("scale_factor")
    if sf is None:
        sf = 1.0
        ck = s2.get("checkpoint")
        if ck:
            sidecar = Path(ck).parent / LATENT_SCALE_FILE
            if sidecar.exists():
                sf = float(json.loads(sidecar.read_text())["scale_factor"])
                print(f"latent scale_factor {sf:.4f} from {sidecar}")
    latent = LatentSliceLDM(inner=inner, first_stage=ae.eval(), cond_stage=None if cond_ae is None else cond_ae.eval(),
                            scale_factor=float(sf))
    return latent, size // ae.downsample_factor


def build_slice_dataset(cfg: dict, split: str) -> SyntheticSliceDataset:
    """The synthetic branch of the JAX CLI's `build_slice_dataset`; splits
    other than 'train' carry the whole volumes.  Other kinds raise."""
    d = cfg.get("dataset", {})
    kind = d.get("kind", "synthetic")
    if kind != "synthetic":
        raise NotImplementedError(f"dataset kind {kind!r} is not ported yet")
    return SyntheticSliceDataset(num_cases=d.get("num_cases", 16),
                                 slice_shape=tuple(d.get("slice_shape", (512, 512))),
                                 depth=d.get("depth", 8), include_volumes=split != "train")
