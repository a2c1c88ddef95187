"""Shared by the CLIs: the first-stage autoencoders, their weights,
the latent (`_ae`) stage 2, checkpoint reading, the slice dataset and the
mask dataset.

Counterpart of the AE, checkpoint and dataset parts of
`jointimagegeneration_tpu/cli/common.py` and `cli/sample.py`
(`build_autoencoder`, `load_ae_params`, `_load_params`, `build_latent_ldm`,
`build_slice_dataset`, `build_mask_dataset`).  A `checkpoint:` key names one
of three things:

  * a directory of `<step>.pt` files, as a port trainer or
    `cli.convert_reference` writes it (`<logdir>/checkpoints/`): the newest
    step's EMA weights, rolling or best (for the AEs: a `cli.train_ae`
    state's generator weights, `g_params`, or else the EMA weights);
  * one such `.pt` file (a train state or a `trainstep/` weights snapshot):
    its EMA weights (the AEs' as above);
  * a flat `.npz` of a JAX parameter tree ('/'-joined keys; the card's
    machine has no orbax): for the AEs a `cli.train_ae` state keeps them
    under `g_params`, a converted reference AE under `params`.

The latent scale factor comes from `first_stage.scale_factor`, else from
`latent_scale.json` inside the UNet's checkpoint directory or beside its
file, else 1.0.

`maybe_init_from` applies a config's `init_from:` warm start (JAX
`cli/common.maybe_init_from`): `init_from: <path>` or `{path, ignore_keys,
only_model, source}` through `core.checkpoint.load_partial`, copied into the
fresh parameters in place before the train state (and so its EMA) is built;
a resuming run ignores it, as its checkpoint restores everything later.

`build_dino_feature_fn` and `feature_cond` are the dense DINO feature route
of a stage-1 config (`feature_cond_encoder: {type: dino, inject_idx: N}`),
as the JAX CLI's: every surface (train, sample) builds the extractor from
`seed + 11` of the same config, drawn on the CPU, so that with uncalibrated
weights the sampler sees the features the UNet was trained on.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.checkpoint import CheckpointManager, load_partial
from ..data.datasets import (NNUNetLayoutDataset, RuijinMaskDataset, RuijinSlicePairDataset, RuijinVolumeDataset,
                             SyntheticMaskDataset, SyntheticSliceDataset)
from ..models.autoencoder import AutoencoderKL, VQModel
from ..models.cond_encoders import build_feature_cond_encoder, inject_site_downsample, make_dense_feature_fn
from ..nn.unet import ZERO_INIT_SUFFIXES
from ..utils.jax_weights import ae_state_dict_from_jax, check_state, flat_paths

__all__ = ["build_autoencoder", "read_port_checkpoint", "load_ae_weights", "build_latent_ldm", "build_slice_dataset",
           "build_mask_dataset", "fill_zero_init", "build_dino_feature_fn", "feature_cond", "LATENT_SCALE_FILE",
           "maybe_init_from"]

LATENT_SCALE_FILE = "latent_scale.json"


def maybe_init_from(cfg: dict, named_params, resume_key: str = "load_from", bridge=None) -> bool:
    """Apply `cfg['init_from']` to `named_params` ((name, parameter) pairs,
    updated in place); returns whether anything was read.  Ignored, with the
    JAX note, when `cfg[resume_key]` or `cfg['resume']` is set.  `bridge`
    maps a JAX `.npz` tree to the parameters' names (the UNet's by
    default)."""
    spec = cfg.get("init_from")
    if not spec:
        return False
    if cfg.get(resume_key) or cfg.get("resume"):
        print("init_from: ignored — run is resuming from its own checkpoints")
        return False
    if isinstance(spec, str):
        spec = {"path": spec}
    params = dict(named_params)
    template = {n: p.detach() for n, p in params.items()}
    merged = load_partial(template, spec["path"], ignore_keys=tuple(spec.get("ignore_keys", ())),
                          only_model=bool(spec.get("only_model", False)), source=spec.get("source", "params"),
                          bridge=bridge)
    with torch.no_grad():
        for name, p in params.items():
            if merged[name] is not template[name]:
                p.copy_(merged[name])
    return True


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


def read_port_checkpoint(ck, what: str = "checkpoint", keys=("ema",)) -> Optional[Dict[str, torch.Tensor]]:
    """The weights (name -> fp32 CPU tensor) under the first of `keys` that a
    port checkpoint `ck` holds: a directory of `<step>.pt` files (the newest
    step) or one `.pt` file, read with `weights_only=True`; None for an
    `.npz` file.  Anything else raises ValueError naming the forms accepted."""
    forms = ("a directory of <step>.pt files as a port trainer or cli.convert_reference writes it, one such .pt "
             "file, or a flat .npz of the JAX parameter tree")
    path = Path(ck)
    if path.is_file() and path.suffix == ".npz":
        return None
    if path.is_dir():
        manager = CheckpointManager(path)
        if manager.latest_step() is None:
            raise ValueError(f"{what} {ck!r} is a directory with no <step>.pt: expected {forms}")
        path = manager.step_path()
    elif not (path.is_file() and path.suffix == ".pt"):
        raise ValueError(f"{what} {ck!r} is not {forms}")
    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    for key in keys:
        if isinstance(saved, dict) and isinstance(saved.get(key), dict):
            print(f"{what}: {'EMA' if key == 'ema' else key} weights of {path}")
            return dict(saved[key])
    raise ValueError(f"{what} {str(path)!r} holds no {' or '.join(repr(k) for k in keys)} weights: expected {forms}")


def load_ae_weights(module: nn.Module, section: Optional[dict], fresh_init_noise: float = 0.0,
                    seed: int = 0) -> None:
    """Load `section['checkpoint']` into `module`, every leaf's name and shape
    checked: a port checkpoint (a `cli.train_ae` GAN state's generator
    weights `g_params`, else the EMA weights of a `.pt` such as
    `cli.convert_reference --ae` writes), or a flat `.npz` of the JAX AE
    variables under `g_params` or `params`.  Without a checkpoint keep the
    fresh init, say so, and fill its zero-init kernels with
    N(0, fresh_init_noise^2) drawn from `seed`."""
    ck = (section or {}).get("checkpoint")
    if not ck:
        print("WARNING: no AE checkpoint configured — using FRESH-INIT (random) first-stage weights")
        if fresh_init_noise:
            fill_zero_init(module, fresh_init_noise, seed)
        return
    state = read_port_checkpoint(ck, "AE checkpoint", keys=("g_params", "ema"))
    if state is not None:
        check_state(module.state_dict(), state, f"AE checkpoint {ck!r} (wrong ddconfig?)")
        module.load_state_dict(state)
        return
    flat = flat_paths(ck)
    for top in ("g_params", "params"):
        tree = {k[1:] if top == "g_params" else k: v for k, v in flat.items() if k[0] == top}
        if tree:
            break
    else:
        raise ValueError(f"AE checkpoint {ck!r} has neither 'g_params' (cli.train_ae) nor 'params' (a converted "
                         f"AE); top-level keys: {sorted({k[0] for k in flat})[:6]}")
    state = ae_state_dict_from_jax(tree)
    check_state(module.state_dict(), state, f"AE checkpoint {ck!r} (wrong ddconfig?)")
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
            sidecar = (Path(ck) if Path(ck).is_dir() else Path(ck).parent) / LATENT_SCALE_FILE
            if sidecar.exists():
                sf = float(json.loads(sidecar.read_text())["scale_factor"])
                print(f"latent scale_factor {sf!r} from {sidecar}")
    for stage in (ae, cond_ae):  # frozen: no gradient, eval mode
        if stage is not None:
            stage.eval().requires_grad_(False)
    latent = LatentSliceLDM(inner=inner, first_stage=ae, cond_stage=cond_ae, scale_factor=float(sf))
    return latent, size // ae.downsample_factor


def build_slice_dataset(cfg: dict, split: str):
    """The stage-2 dataset of `cfg['dataset']`, as the JAX CLI's
    `build_slice_dataset`: `synthetic` (splits other than 'train' carry the
    whole volumes), `ruijin` (`index`: the JSON index), `nnunet` (`root`:
    the nnUNet tree), and the stock kinds of `data/stock.py`: `lsun`
    (`txt_file` + `data_root`, or a `category`), `imagenet` (`root`: a
    `<synset>/<file>` tree, optional `filelist` and `synsets`) and
    `imagenet_sr` (the same tree as SR pairs: `size`, `degradation`,
    `downscale_f`, `min_crop_f`, `max_crop_f`).  A stock kind's `size`
    falls back to `slice_shape[0]`; `imagenet` and `imagenet_sr` crop at
    random and `lsun` flips (p = `flip_p`, 0.5) only on the 'train' split.
    Any other kind raises ValueError."""
    d = cfg.get("dataset", {})
    kind = d.get("kind", "synthetic")
    shape = tuple(d.get("slice_shape", (512, 512)))
    if kind == "synthetic":
        return SyntheticSliceDataset(num_cases=d.get("num_cases", 16), slice_shape=shape, depth=d.get("depth", 8),
                                     include_volumes=split != "train")
    if kind == "ruijin":
        return RuijinSlicePairDataset(d["index"], split=split, slice_shape=shape)
    if kind == "nnunet":
        return NNUNetLayoutDataset(d["root"], split=split, slice_shape=shape, num_classes=cfg.get("num_classes", 12))
    if kind == "lsun":  # unconditional: pair with cond_channels 0, channels 3
        from ..data.stock import LSUNBase, lsun_dataset

        if "txt_file" in d:
            return LSUNBase(d["txt_file"], d["data_root"], size=d.get("size", shape[0]),
                            flip_p=d.get("flip_p", 0.5 if split == "train" else 0.0))
        return lsun_dataset(d["category"], "train" if split == "train" else "val", size=d.get("size", shape[0]))
    if kind == "imagenet":
        from ..data.stock import ImageNetLocal

        return ImageNetLocal(d["root"], filelist=d.get("filelist"), size=d.get("size", shape[0]),
                             synsets=d.get("synsets"), random_crop=split == "train")
    if kind == "imagenet_sr":  # HR target, cond the bicubic-upsampled LR (imagenet.py:272-374)
        from ..data.stock import ImageNetLocal, SRDataset, SRToLDMAdapter

        base = ImageNetLocal(d["root"], filelist=d.get("filelist"), process_images=False, synsets=d.get("synsets"))
        return SRToLDMAdapter(SRDataset(base, size=d.get("size", shape[0]),
                                        degradation=d.get("degradation", "bsrgan_light"),
                                        downscale_f=d.get("downscale_f", 4), min_crop_f=d.get("min_crop_f", 0.5),
                                        max_crop_f=d.get("max_crop_f", 1.0), random_crop=split == "train"))
    raise ValueError(f"unknown dataset kind {kind!r}")


def build_mask_dataset(cfg: dict, split: str = "train"):
    """The stage-1 dataset of `cfg['dataset']`, as the JAX CLI's
    `build_mask_dataset`: `synthetic` (the split does not change it; with a
    `selfattn` feature_cond_encoder each case carries an N(0, 1) "context" of
    (dataset.context_len (4), embed_dim (768))), `ruijin` (`index`, with
    `max_size`) or `ruijin_3d` (CT volume, mask and text).  Any other kind
    raises ValueError."""
    d = cfg.get("dataset", {})
    kind = d.get("kind", "synthetic")
    shape = tuple(d.get("volume_shape", (64, 128, 128)))
    num_classes = cfg.get("num_classes", 12)
    if kind == "synthetic":
        fce = cfg.get("feature_cond_encoder") or {}
        ctx_shape = (d.get("context_len", 4), fce.get("embed_dim", 768)) if fce.get("type") == "selfattn" else None
        return SyntheticMaskDataset(num_cases=d.get("num_cases", 16), volume_shape=shape, num_classes=num_classes,
                                    context_shape=ctx_shape, seed=d.get("seed", 0))
    if kind == "ruijin":
        return RuijinMaskDataset(d["index"], split=split, volume_shape=shape, num_classes=num_classes,
                                 max_size=d.get("max_size"))
    if kind == "ruijin_3d":
        return RuijinVolumeDataset(d["index"], split=split, volume_shape=shape, num_classes=num_classes)
    raise ValueError(f"unknown dataset kind {kind!r}")


def build_dino_feature_fn(cfg: dict, spatial, device, seed: Optional[int] = None):
    """(feat_fn, inject_idx, site_shape) for a stage-1 config with
    `feature_cond_encoder: {type: dino, inject_idx (1), layer (11), facet
    ('key'), model_type, output_stride, weights_path}`, or (None, None,
    None) without one.  `feat_fn` maps (B, H, W, C) images to the (B, th,
    tw, D) features at the injection site's grid (`spatial` over its
    downsample factor), `site_shape` = (th, tw, D).  The extractor is seeded
    with `seed`, by default the config's `seed` + 11.  2D only: `dims` other
    than 2 raises ValueError."""
    fce = cfg.get("feature_cond_encoder") or {}
    if fce.get("type") != "dino":
        return None, None, None
    if cfg.get("dims", 3) != 2:
        raise ValueError("dino dense feature conditioning is 2D (the extractor is a 2D ViT); set dims: 2 / use a "
                         "2D dataset variant")
    seed = int(cfg.get("seed", 0)) + 11 if seed is None else seed
    enc, _ = build_feature_cond_encoder(fce, device, seed)
    u = cfg.get("unet_openai", {})
    idx = int(fce.get("inject_idx", 1))
    dsf = inject_site_downsample(tuple(u.get("channel_mult", (1, 2, 2, 4, 5))), u.get("num_res_blocks", 2), idx)
    site = (spatial[0] // dsf, spatial[1] // dsf)
    fn = make_dense_feature_fn(enc, site, layer=fce.get("layer", 11), facet=fce.get("facet", "key"))
    return fn, idx, (*site, enc.vit.dim)


def feature_cond(feat_fn, feat_idx, cond) -> Optional[dict]:
    """The {inject_idx: features} dict every surface hands the UNet (None
    without an extractor)."""
    return None if feat_fn is None else {feat_idx: feat_fn(cond)}
