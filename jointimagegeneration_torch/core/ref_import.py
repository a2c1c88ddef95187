"""Importer for the reference's own config files -> the port's configs.

The port's own copy of `jointimagegeneration_tpu/core/ref_import.py` (no
JAX in either).  The reference has two config generations: ccdm's flat YAML
(`ccdm/params.yml`, `params_eval.yml`) and latentdiffusion's OmegaConf trees
(`configs/latent-diffusion/*.yaml`, `configs/autoencoder/*.yaml`).  This module
translates all four families into the config tree the CLIs consume (the JAX
package's and the port's read the same keys), so a reference user can run

    python -m jointimagegeneration_torch.core.ref_import ccdm/params.yml -o stage1.yml
    python -m jointimagegeneration_torch.cli.train_mask stage1.yml exp

Every translated key lands on the equivalent key (MIGRATION.md "Config key
map"); reference keys with no equivalent — or whose semantics changed (epoch
vs step budgets, torch checkpoint paths that need
`jointimagegeneration_torch.cli.convert_reference`) — are returned as
human-readable warnings so nothing is dropped silently.  The trees are the JAX
importer's, `remat: true` and `init_from` included, which the port's trainers
run (`nn/unet.py`'s remat, `cli/common.maybe_init_from`).  `yaml` is
imported only by `_main`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["detect_kind", "import_reference_config"]

_CONVERT_HINT = ("convert it with `python -m jointimagegeneration_torch.cli.convert_reference` and "
                 "point {key} at the directory it writes")


def detect_kind(cfg: Dict[str, Any]) -> str:
    """'ccdm_train' | 'ccdm_eval' | 'ldm' | 'ae' (raises on anything else)."""
    model = cfg.get("model")
    if isinstance(model, dict) and "target" in model:
        target = str(model["target"])
        if "autoencoder" in target.lower():
            return "ae"
        return "ldm"
    if any(k in cfg for k in ("unet_openai", "diffusion_type", "backbone")):
        if "evaluations" in cfg or "dataset_split" in cfg:
            return "ccdm_eval"
        return "ccdm_train"
    raise ValueError(
        "unrecognized reference config: expected ccdm params[_eval].yml keys "
        "(unet_openai/diffusion_type/backbone) or an OmegaConf tree with "
        "model.target (latent-diffusion / autoencoder yaml)")


def import_reference_config(cfg: Dict[str, Any]) -> Tuple[Dict[str, Any], List[str]]:
    """Translate a parsed reference config dict.  Returns (config, warnings)."""
    kind = detect_kind(cfg)
    return {
        "ccdm_train": _import_ccdm_train,
        "ccdm_eval": _import_ccdm_eval,
        "ldm": _import_ldm,
        "ae": _import_ae,
    }[kind](cfg)


# ---------------------------------------------------------------------------
# ccdm (stage 1)
# ---------------------------------------------------------------------------

def _ccdm_dataset(cfg, warn) -> Dict[str, Any]:
    ds_file = str(cfg.get("dataset_file", ""))
    if ds_file.endswith("ruijin"):
        # datasets.ruijin → RuijinMaskDataset (12 classes, 64x128x128 —
        # ccdm/datasets/ruijin.py:176-178); needs an index built by
        # cli.build_index
        out = {"kind": "ruijin", "volume_shape": [64, 128, 128],
               "index": "SET_ME: path/to/index.json (cli.build_index)"}
    else:
        warn(f"dataset_file: {ds_file!r} has no mapped dataset here — "
             "emitting `dataset.kind: synthetic`; use kind ruijin/ruijin_3d/"
             "nnunet for real data")
        out = {"kind": "synthetic", "volume_shape": [64, 128, 128]}
    for k in ("dataset_pipeline_train", "dataset_pipeline_val"):
        if k in cfg:
            warn(f"{k} (2D augmentation pipeline) is dataset-level here — "
                 "see data/transforms.py / data/pipelines.py")
    if cfg.get("dataset_val_max_size") not in (None, "null"):
        out["val_max_size"] = cfg["dataset_val_max_size"]
    return out


def _ccdm_fce(cfg, warn):
    fce = dict(cfg.get("feature_cond_encoder") or {})
    if not fce or fce.get("type") in (None, "none"):
        return {"type": "none"}
    out = {"type": fce["type"]}
    for k in ("embed_dim", "n_heads", "model_depth", "d_head", "dropout", "train", "model"):
        if k in fce:
            out[k] = fce[k]
    if "channels" in fce and "embed_dim" not in out:
        out["embed_dim"] = fce["channels"]
    if "source_layer" in fce:
        out["layer"] = fce["source_layer"]
    for k in ("output_stride", "target_layer", "conditioning", "scale"):
        if k in fce:
            warn(f"feature_cond_encoder.{k} → the UNet inject site is chosen "
                 "with `feature_cond_encoder.inject_idx` here (level index, "
                 "not output stride)")
            break
    return out


def _import_ccdm_train(cfg):
    warnings: List[str] = []
    warn = warnings.append
    u = dict(cfg.get("unet_openai") or {})
    out: Dict[str, Any] = {
        "output_path": cfg.get("output_path", "runs/stage1"),
        "num_classes": 12,  # from the dataset module (ruijin.get_num_classes)
        "time_steps": cfg.get("time_steps", 1000),
        "beta_schedule": cfg.get("beta_schedule", "cosine"),
        "batch_size": cfg.get("batch_size", 1),
        "class_weights": cfg.get("class_weights", "uniform"),
        "polyak_alpha": cfg.get("polyak_alpha", 0.9999),
        "save_freq": cfg.get("save_freq", 1000),
        "display_freq": cfg.get("display_freq", 100),
        "n_validation_images": cfg.get("n_validation_images", 2),
        "mp_loaders": cfg.get("mp_loaders", 2),
        "dims": cfg.get("dims", 3),
        # TPU-side defaults with no reference knob: bf16 torso (the
        # fp16_util.py analog) and rematerialization (full-scale fwd+bwd
        # at 64x128x128 OOMs a 16 GB chip without it)
        "bf16": True,
        "remat": True,
        "unet_openai": {k: u[k] for k in
                        ("base_channels", "channel_mult", "attention_resolutions",
                         "num_res_blocks", "num_head_channels") if k in u},
        "feature_cond_encoder": _ccdm_fce(cfg, warn),
        "dataset": _ccdm_dataset(cfg, warn),
    }
    if "optim" in cfg:
        o = dict(cfg["optim"])
        out["optim"] = {k: o[k] for k in
                        ("name", "learning_rate", "lr_function", "lr_params") if k in o}
        if "epochs" in o:
            warn("optim.epochs (epoch-denominated LR horizon) → the LR schedule "
                 "here runs over `max_steps` steps; set max_steps = epochs × "
                 "len(dataset) / batch_size")
    bsp = cfg.get("beta_schedule_params") or {}
    if bsp and abs(float(bsp.get("s", 8e-3)) - 8e-3) > 1e-12:
        warn(f"beta_schedule_params.s={bsp['s']} — the cosine schedule here uses "
             "the same s=0.008 default; a different s is not config-exposed")
    if "max_epochs" in cfg:
        warn(f"max_epochs: {cfg['max_epochs']} → training here is step-budgeted; "
             "set `max_steps` (defaulted to 100000)")
        out["max_steps"] = 100_000
    if u.get("num_head_channels", 32) == -1 and "num_heads" in u:
        warn("unet_openai.num_head_channels=-1 with num_heads: fixed head COUNT "
             "is not exposed here — set num_head_channels = channels // num_heads")
    if cfg.get("load_from"):
        warn(f"load_from: {cfg['load_from']!r} is a torch checkpoint — "
             + _CONVERT_HINT.format(key="`init_from.path` (or `load_from: true` "
                                        "for an orbax resume)"))
    if cfg.get("wandb"):
        out["wandb_project"] = cfg.get("wandb_project", "ccdm")
        out["wandb_mode"] = cfg.get("wandb_mode", "offline")
    for k in ("cudnn", "distributed", "multigpu"):
        if cfg.get(k):
            warn(f"{k}: distribution is mesh-implicit here (parallel/mesh.py) — "
                 "no backend/spawn config; run one process per host")
    if "validation_freq" in cfg:
        warn("validation_freq (epochs) → `eval_every` (steps) here")
    if "samples" in cfg:
        warn("samples (GED sample count) is an eval-time knob → eval/metrics.py "
             "generalized_energy_distance")
    return out, warnings


def _import_ccdm_eval(cfg):
    warnings: List[str] = []
    warn = warnings.append
    u = dict(cfg.get("unet_openai") or {})
    stage1: Dict[str, Any] = {
        "num_classes": 12,
        "time_steps": 1000,
        "beta_schedule": cfg.get("beta_schedule", "cosine"),
        "bf16": True,
        "unet_openai": {k: u[k] for k in
                        ("base_channels", "channel_mult", "attention_resolutions",
                         "num_res_blocks", "num_head_channels") if k in u},
        "feature_cond_encoder": _ccdm_fce(cfg, warn),
        "dataset": _ccdm_dataset(cfg, warn),
    }
    out: Dict[str, Any] = {
        "stage": "mask",
        "output_path": cfg.get("output_path", "samples/mask"),
        "seed": 1024,  # ddpm_eval.py:set_seeds(1024)
        # params_eval.yml sets time_steps to the EVAL chain length (250)
        # while the trained schedule stays T=1000 — here those are two
        # explicit knobs
        "mask_steps": cfg.get("time_steps", 250),
        "step_T_sample": cfg.get("evaluation_vote_strategy", "majority"),
        "batch_size": cfg.get("batch_size", 1),
        "split": cfg.get("dataset_split", "val"),
        "stage1": stage1,
    }
    if "samples" in cfg:  # GED repeat-sample count (params.yml:26)
        out["samples"] = cfg["samples"]
    if cfg.get("evaluations", 1) > 1:
        warn(f"evaluations: {cfg['evaluations']} (repeat-sample voting) — run the "
             "sample CLI with distinct seeds and vote offline, or use "
             "eval/metrics.py GED utilities")
    if cfg.get("load_from"):
        warn(f"load_from: {cfg['load_from']!r} is a torch checkpoint — "
             + _CONVERT_HINT.format(key="`stage1.checkpoint`"))
        stage1["checkpoint"] = "SET_ME: converted checkpoint dir"
    return out, warnings


# ---------------------------------------------------------------------------
# latentdiffusion (stage 2 + AE)
# ---------------------------------------------------------------------------

def _is_sentinel(v) -> bool:
    return isinstance(v, str) and v.startswith("__") and v.endswith("__")


def _dataset_from_data_section(cfg, warn) -> Dict[str, Any]:
    data = (cfg.get("data") or {}).get("params", {})
    target = str(((data.get("train") or {}).get("target")) or "")
    out: Dict[str, Any] = {}
    if "ruijin_pimage_and_mask" in target or target.endswith("ruijin.AutoencoderDataset"):
        out["kind"] = "ruijin"
        out["index"] = "SET_ME: path/to/index.json (cli.build_index)"
    elif "ruijin_3d" in target:
        out["kind"] = "ruijin_3d"
        out["index"] = "SET_ME: path/to/index.json"
    elif "cmu" in target:
        out["kind"] = "nnunet"
        out["root"] = "SET_ME: nnUNet-layout dataset root"
    else:
        if target:
            warn(f"data.train.target {target!r} has no mapped dataset here — "
                 "emitting `dataset.kind: synthetic`")
        out["kind"] = "synthetic"
    return out


def _ae_section(section, warn, *, what: str) -> Dict[str, Any]:
    """first_stage_config / cond_stage_config (AutoencoderKL|VQModel dict)
    → our first_stage/cond_stage section."""
    p = dict(section.get("params") or {})
    out: Dict[str, Any] = {"embed_dim": p.get("embed_dim", 4)}
    if "VQModel" in str(section.get("target", "")):
        out["type"] = "vq"
        if "n_embed" in p:
            out["n_embed"] = p["n_embed"]
    dd = dict(p.get("ddconfig") or {})
    dd.pop("double_z", None)  # always true for the KL posterior here
    out["ddconfig"] = dd
    if p.get("ckpt_path"):
        warn(f"{what}.ckpt_path {p['ckpt_path']!r} is a torch Lightning checkpoint — "
             + _CONVERT_HINT.format(key=f"`{what}.checkpoint`") + " (use --ae)")
        out["checkpoint"] = "SET_ME: converted AE checkpoint dir"
    return out


def _import_ldm(cfg):
    warnings: List[str] = []
    warn = warnings.append
    m = cfg.get("model") or {}
    p = dict(m.get("params") or {})
    up = dict((p.get("unet_config") or {}).get("params") or {})

    channels = p.get("channels", 1)
    in_ch, out_ch = up.get("in_channels"), up.get("out_channels", channels)
    cond_channels = (in_ch - out_ch) if in_ch is not None else 2

    model: Dict[str, Any] = {
        "base_learning_rate": m.get("base_learning_rate", 2e-6),
        "timesteps": p.get("timesteps", 1000),
        "beta_schedule": p.get("beta_schedule", "linear"),
        "linear_start": p.get("linear_start", 0.0015),
        "linear_end": p.get("linear_end", 0.0195),
        "channels": channels,
        "cond_channels": cond_channels,
        "bf16": True,
        "unet_config": {"params": {k: up[k] for k in
                                   ("model_channels", "channel_mult",
                                    "attention_resolutions", "num_res_blocks",
                                    "num_head_channels", "num_heads", "num_classes")
                                   if k in up}},
    }
    for k in ("learn_logvar", "logvar_init", "scale_by_std", "loss_type",
              "l_simple_weight", "original_elbo_weight", "use_ema"):
        if k in p:
            model[k] = p[k]

    sc = p.get("scheduler_config")
    if isinstance(sc, dict):
        # ldm.lr_scheduler classes -> train/optim.py lr_function names
        tgt = str(sc.get("target", ""))
        sp = dict(sc.get("params") or {})
        kind = ("warmup-linear" if "LambdaLinearScheduler" in tgt else
                "warmup-cosine2" if "CosineScheduler2" in tgt else
                "warmup-cosine" if "CosineScheduler" in tgt else None)
        if kind is None:
            warn(f"scheduler_config.target {tgt!r} has no mapping "
                 "(known: LambdaWarmUpCosineScheduler[2], LambdaLinearScheduler)")
        else:
            model["scheduler"] = {"type": kind, "params": {
                k: sp[k] for k in ("warm_up_steps", "f_min", "f_max", "f_start",
                                   "cycle_lengths", "lr_min", "lr_max", "lr_start",
                                   "max_decay_steps") if k in sp}}

    fs = p.get("first_stage_config")
    if isinstance(fs, dict) and not _is_sentinel(fs.get("target", "")):
        model["first_stage"] = _ae_section(fs, warn, what="model.first_stage")
    cs = p.get("cond_stage_config")
    if isinstance(cs, dict):
        target = str(cs.get("target", ""))
        if "autoencoder" in target.lower():
            model["cond_stage"] = _ae_section(cs, warn, what="model.cond_stage")
        elif "IdentityEncoder" not in target and not _is_sentinel(target):
            warn(f"cond_stage_config.target {target!r}: text/class cond stages map "
                 "to `text:`/adm keys here (nn/text.py, unet num_classes), not a "
                 "cond_stage section")

    data = (cfg.get("data") or {}).get("params", {})
    lightning = (cfg.get("lightning") or {})
    trainer = lightning.get("trainer") or {}
    out: Dict[str, Any] = {
        "output_path": "runs/stage2",
        "batch_size": data.get("batch_size", 1),
        "num_workers": data.get("num_workers", 2),
        "accumulate_grad_batches": trainer.get("accumulate_grad_batches", 1),
        "scale_lr": True,  # main.py:772-776 default (the CLI's --scale_lr)
        "model": model,
        "dataset": _dataset_from_data_section(cfg, warn),
    }
    size = p.get("image_size") if "first_stage" not in model else (
        (model.get("first_stage", {}).get("ddconfig") or {}).get("resolution"))
    if size:
        out["dataset"]["slice_shape"] = [int(size), int(size)]
    il = ((lightning.get("callbacks") or {}).get("image_logger") or {}).get("params", {})
    if "batch_frequency" in il:
        out["eval_every"] = il["batch_frequency"]  # image panels land at eval here
    for k in ("num_timesteps_cond", "log_every_t", "monitor",
              "first_stage_key", "cond_stage_key"):
        if k in p and k in ("num_timesteps_cond", "log_every_t"):
            warn(f"model.params.{k} has no equivalent (panels follow eval_every)")
    if up.get("dims", 2) != 2:
        warn(f"unet_config.params.dims={up.get('dims')}: the slice LDM here is 2D "
             "(volumes are generated autoregressively along z)")
    if "max_epochs" in trainer:
        warn("lightning.trainer.max_epochs → step-budgeted `max_steps` here")
    return out, warnings


def _import_ae(cfg):
    warnings: List[str] = []
    warn = warnings.append
    m = cfg.get("model") or {}
    p = dict(m.get("params") or {})
    lc = dict((p.get("lossconfig") or {}).get("params") or {})

    dd = dict(p.get("ddconfig") or {})
    dd.pop("double_z", None)
    model: Dict[str, Any] = {
        "base_learning_rate": m.get("base_learning_rate", 4.5e-6),
        "embed_dim": p.get("embed_dim", 4),
        "ddconfig": dd,
        "lossconfig": {k: lc[k] for k in
                       ("kl_weight", "disc_weight", "disc_start", "disc_num_layers",
                        "disc_ndf", "gan_feat_weight", "codebook_weight",
                        "pixel_loss", "disc_loss") if k in lc},
    }
    if "VQModel" in str(m.get("target", "")):
        model["type"] = "vq"
        if "n_embed" in p:
            model["n_embed"] = p["n_embed"]
    if "disc_in_channels" in lc and lc["disc_in_channels"] != dd.get("in_channels", 1):
        warn(f"lossconfig.disc_in_channels={lc['disc_in_channels']} differs from "
             f"ddconfig.in_channels={dd.get('in_channels', 1)} — the discriminator "
             "here always sees the AE's own channels")
    if p.get("ckpt_path"):
        warn(f"model.params.ckpt_path {p['ckpt_path']!r} — "
             + _CONVERT_HINT.format(key="`init_from.path`") + " (use --ae)")
    if "image_key" in p and p["image_key"] != "image":
        warn(f"image_key: {p['image_key']!r} — select the trained tensor via the "
             "dataset section (e.g. a 2-channel cond AE uses ddconfig.in_channels=2 "
             "over the [prev, mask] pair)")

    data = (cfg.get("data") or {}).get("params", {})
    trainer = ((cfg.get("lightning") or {}).get("trainer") or {})
    out = {
        "output_path": "runs/stage_ae",
        "batch_size": data.get("batch_size", 1),
        "num_workers": data.get("num_workers", 2),
        "model": model,
        "dataset": _dataset_from_data_section(cfg, warn),
    }
    if trainer.get("accumulate_grad_batches", 1) != 1:
        warn("lightning.trainer.accumulate_grad_batches is not wired for the AE's "
             "dual-optimizer step (alternating G/D updates make optax MultiSteps "
             "ill-defined); raise batch_size instead (b=8 measured faster per "
             "sample on TPU, BENCH_NOTES)")
    if dd.get("resolution"):
        out["dataset"]["slice_shape"] = [int(dd["resolution"]), int(dd["resolution"])]
    return out, warnings


def _main(argv=None):
    import argparse
    import sys

    import yaml

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ref_yaml", help="reference config (params.yml / *.yaml)")
    ap.add_argument("-o", "--out", help="write the translated config here "
                                        "(default: stdout)")
    args = ap.parse_args(argv)
    with open(args.ref_yaml) as f:
        cfg = yaml.safe_load(f)
    kind = detect_kind(cfg)
    out, warnings = import_reference_config(cfg)
    text = yaml.safe_dump(out, sort_keys=False)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"{kind}: wrote {args.out}")
    else:
        sys.stdout.write(text)
    for w in warnings:
        print(f"NOTE: {w}", file=sys.stderr)
    cli = {"ccdm_train": "cli.train_mask", "ccdm_eval": "cli.sample",
           "ldm": "cli.train_ldm", "ae": "cli.train_ae"}[kind]
    print(f"run it with: python -m jointimagegeneration_torch.{cli} "
          f"{args.out or '<cfg>'}", file=sys.stderr)


if __name__ == "__main__":
    _main()
