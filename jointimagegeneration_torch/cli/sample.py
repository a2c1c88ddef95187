"""Sampling CLI: `stage: two_stage` (stage-1 mask volume -> stage-2 CT volume),
`stage: mask` (stage 1 alone, on the mask dataset's cases) or `stage: ct`
(stage 2 alone, on the slice dataset's masks).

    python -m jointimagegeneration_torch.cli.sample <config.yml> [k=v ...] [device=cpu]

Reads the keys of `configs/sample_two_stage.yml` and `configs/sample_ct_ae.yml`
(the JAX CLI's format) and writes per case, under `output_path`,
`case_XXXX/image.nii.gz` and `image.png`, with `overlay.png` (the labels over
the CT); `two_stage` adds `pred.nii.gz` and `pred.png`, written by a pool of
two threads while the next batch samples (the native NIfTI writer releases
the GIL), every write finished and its error raised before `run` returns.
`stage: mask` writes
per case `pred.nii.gz`, `pred.png` (the first of `samples` draws) and
`gt.nii.gz`, and prints the mean foreground Dice, with GED and HM-IoU over the
draws when `samples` > 1; its cases run in batches of `batch_size`, a ragged
last batch padded by repeating its last case.  Runs on CUDA unless
`device=cpu` is given.  With `batch_size` > 1, `stage: mask` and
`two_stage` cut each batch's rows over the data axis of
`parallel.mesh.make_mesh_for_batch` (the local cards: the largest number of
them that divides the batch), as the JAX CLI shards its batch: each UNet
call runs its rows on their own card with its copy of the weights, the
samplers' arithmetic and draws on the whole batch on `device`; on one card
the mesh is 1 x 1 and nothing changes.  The AEs and the text refiner run on
`device`.  `run(cfg)` is the same entry point for a config that
is already a dict.

Text guidance: a stage-1 section with `feature_cond_encoder: {type: selfattn,
embed_dim: D}` builds the cross-attention UNet and, unless `train: false`,
the trained text refiner (its weights come with the UNet's from the stage-1
checkpoint, never a fresh init when one is given).  `text: {features_npz:
path}` reads the file's first array (T, D) as the context, `text:
{bert_path: dir, prompt: str}` encodes the prompt with a frozen local BERT
(`nn.text.FrozenBERTEmbedder`); the context is tiled over the batch and goes
to stage 1 only (`mask` and `two_stage`).

Stage 2 is the pixel-space SliceLDM, or with `stage2.first_stage` (and a
`cond_stage`) the latent `_ae` route (`models/latent_ldm.py`): the KL-VAEs
encode each [previous slice | mask slice] pair and decode each latent slice.
The stage-2 options of the JAX CLI, read at the top level or under `stage2`:
`sampler` (ddim, plms or dpm), `warm_start`, `guidance_scale`,
`ddim_discretize` (uniform, quad or uniform_lambda), and for `stage: ct` on
the pixel route `tile: {patch, stride}` (the latent route ignores it and
says so).  `stage: ct` computes the three-view LPIPS of each case against the
dataset's volume (`metrics`, default on; `lpips_weights` names calibrated
weights) and writes `metrics.json`.

Keys beyond the JAX CLI's:
  * `chunk: N` runs the two-stage stage 2 in chunks of N slices, each seeded
    with the previous chunk's last slice;
  * `slices: N` generates only the first N CT slices (image and pred are then
    N slices deep), a multiple of `chunk`; under `stage: ct` it cuts the
    dataset's volume;
  * `fresh_init_noise: s` fills the zero-initialised kernels of fresh-init
    weights (the UNets' and the AEs') with N(0, s^2), so that every layer of a
    random network carries signal (smoke runs; checkpoints are unaffected).

`stage: mask` and `stage: ct` take their cases from the dataset of the stage's
section (`dataset.kind` `synthetic`, `ruijin`, `ruijin_3d` or `nnunet`, see
`cli/common.py`) on the split `split` (default 'val'): the mask and CT of
each item are the ground truth of the Dice and LPIPS.

Weights: `stage1.checkpoint` / `stage2.checkpoint`, and for the AEs
`first_stage.checkpoint` / `cond_stage.checkpoint`, name a port trainer's
`checkpoints/` directory (its newest step), one of its `.pt` files, or a flat
`.npz` of the JAX parameter tree ('/'-joined keys); the EMA weights are read.
A text-guided stage 1 holds the UNet's and the refiner's ({"unet",
"refiner"}), a stage 2 trained with `learn_logvar` the UNet's and `logvar`
({"unet", "logvar"}), which sampling drops.  Every leaf's name and shape is
checked (`cli/common.py`).  Without a checkpoint the sampler uses a seeded
fresh init and says so.

Dense DINO features: a 2D stage-1 section with `feature_cond_encoder: {type:
dino, inject_idx: N}` builds the UNet widened at that encoder site and the
frozen ViT extractor from the section's `seed` + 11 (the rule of the trainer,
so an uncalibrated extractor gives the features the UNet was trained on);
`stage: mask` and `two_stage` feed each batch's condition image through it.

FVD: `stage: ct` over two or more cases with metrics adds `fvd`,
`fvd_feature_extractor` and `fvd_backbone` to metrics.json: the port's I3D
when `i3d_weights` names a converted `.npz` (`cli/convert_i3d.py`), else the
uncalibrated pyramid features.

Not ported here: stage-2 context or class conditioning; asking for it raises.
`tile:` on `two_stage` is ignored with a warning and the volume sampled
untiled, as the JAX CLI ignores it there.
"""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.config import load_yaml_config
from ..core.runtime import configure_precision, resolve_device, synchronize
from ..data.nifti import save_image_volume, save_label_volume
from ..diffusion.ddim import DDIMParams
from ..diffusion.noise import NoiseSource
from ..eval.fvd import fvd, i3d_npz_feature_fn
from ..eval.metrics import generalized_energy_distance, hungarian_matched_iou, per_class_dice
from ..eval.writers import image_volume_to_grid, labels_to_grid, overlay_volume_to_grid, save_grid_png
from ..models.mask_sampler import MaskSampler
from ..models.slice_ldm import SliceLDM
from ..nn.unet import UNet
from ..nn.vit import vit_config
from ..parallel.mesh import make_mesh_for_batch
from ..pipeline.two_stage import make_chunked_two_stage_programs
from ..utils.jax_weights import check_state, unet_state_dict_from_jax
from .common import (build_dino_feature_fn, build_latent_ldm, build_mask_dataset, build_slice_dataset, feature_cond,
                     fill_zero_init, read_port_checkpoint)

__all__ = ["build_mask_sampler", "build_slice_ldm", "load_weights", "load_mask_weights", "load_text_context",
           "run", "main"]


def build_mask_sampler(cfg: dict, device, cond_channels: int = 1, seed: int = 0,
                       **unet_options) -> MaskSampler:
    """cfg keys mirror ccdm params.yml (unet_openai + diffusion sections);
    `seed` seeds the UNet's fresh init (the refiner's with seed + 1).
    `feature_cond_encoder: {type: selfattn}` sets the UNet's `context_dim`
    to its `embed_dim` and adds the trainable refiner unless `train: false`;
    `{type: dino}` widens the UNet at `inject_idx` (1) by the ViT's width.
    `unet_options` (`use_fused_resblock`, `use_pallas_conv`) go to
    `MaskSampler.create`; no config key sets them, as in the JAX CLI."""
    u = cfg.get("unet_openai", {})
    fce = cfg.get("feature_cond_encoder") or {}
    kind = fce.get("type", "none")
    if kind not in (None, "none", "selfattn", "dino"):
        raise ValueError(f"unknown feature_cond_encoder type {kind!r}")
    selfattn = kind == "selfattn"
    feature_cond_channels = None
    if kind == "dino":
        feature_cond_channels = {int(fce.get("inject_idx", 1)): vit_config(fce.get("model_type", "vits8"))[0]}
    return MaskSampler.create(
        num_classes=cfg.get("num_classes", 12),
        cond_channels=cond_channels,
        time_steps=cfg.get("time_steps", 1000),
        schedule=cfg.get("beta_schedule", "cosine"),
        model_channels=u.get("base_channels", 64),
        channel_mult=tuple(u.get("channel_mult", (1, 2, 2, 4, 5))),
        attention_resolutions=tuple(u.get("attention_resolutions", (32, 16, 8))),
        num_res_blocks=u.get("num_res_blocks", 2),
        num_head_channels=u.get("num_head_channels", 32),
        dims=cfg.get("dims", 3),
        dtype=torch.bfloat16 if cfg.get("bf16", True) else torch.float32,
        step_T_sample=cfg.get("step_T_sample", "majority"),
        device=device,
        seed=seed,
        remat=bool(cfg.get("remat", False)),
        remat_levels=cfg.get("remat_levels"),
        remat_policy=cfg.get("remat_policy"),
        context_dim=fce.get("embed_dim") if selfattn else None,
        text_refiner=fce if selfattn and fce.get("train", True) else None,
        feature_cond_channels=feature_cond_channels,
        **unet_options,
    )


def build_slice_ldm(cfg: dict, device, seed: int = 1, **options) -> SliceLDM:
    """cfg keys mirror the LDM yaml model.params section; `seed` seeds the
    UNet's fresh init (1 for sampling, the run's seed for training), and
    `options` (`learn_logvar`, `logvar_init`) go to `SliceLDM.create`.  The
    UNet config's `context_dim` builds the cross-attention sites, sized as
    the JAX CLIs' init sizes them without a context shape (`context_free`:
    no CLI hands stage 2 a context), its `num_classes` (or the section's
    `adm_classes`) the 'adm' label embedding; `remat`, `remat_policy` and `remat_levels` are read from the
    section."""
    u = cfg.get("unet_config", {}).get("params", cfg.get("unet", {}))
    return SliceLDM.create(
        image_channels=cfg.get("channels", 1),
        cond_channels=cfg.get("cond_channels", 2),
        timesteps=cfg.get("timesteps", 1000),
        beta_schedule=cfg.get("beta_schedule", "linear"),
        linear_start=cfg.get("linear_start", 0.0015),
        linear_end=cfg.get("linear_end", 0.0195),
        model_channels=u.get("model_channels", 128),
        channel_mult=tuple(u.get("channel_mult", (1, 2, 4, 4, 5))),
        attention_resolutions=tuple(u.get("attention_resolutions", (32, 16, 8))),
        num_res_blocks=u.get("num_res_blocks", 2),
        num_head_channels=u.get("num_head_channels", 32),
        context_dim=u.get("context_dim"),
        context_free=True,
        transformer_depth=u.get("transformer_depth", 1),
        adm_classes=u.get("num_classes", cfg.get("adm_classes")),
        dtype=torch.bfloat16 if cfg.get("bf16", True) else torch.float32,
        remat=bool(cfg.get("remat", False)),
        remat_levels=cfg.get("remat_levels"),
        remat_policy=cfg.get("remat_policy"),
        device=device,
        seed=seed,
        **options,
    )


def _check_stage(cfg: dict, s1: dict, s2: dict, stage: str) -> None:
    """A known stage, and no class-conditional stage-2 UNet: the CLI, as the
    JAX one, hands stage 2 no class ids, where the JAX UNet's assert stops
    the run; here a ValueError names the missing `y` before any step.  A
    `context_dim` UNet samples without a context (attn2 over x itself), as
    the JAX CLI passes none."""
    if stage not in ("mask", "ct", "two_stage"):
        raise ValueError(f"unknown stage {stage!r}: expected 'mask', 'ct', or 'two_stage'")
    u2 = s2.get("unet_config", {}).get("params", s2.get("unet", {}))
    if stage != "mask" and u2.get("num_classes", s2.get("adm_classes")) is not None:
        raise ValueError(f"stage {stage!r}: the stage-2 UNet is class-conditional (num_classes="
                         f"{u2.get('num_classes', s2.get('adm_classes'))}) but the sampling CLI has no class ids `y` "
                         "to give it; sample it through SliceLDM.sample_volume(..., y=...)")


def _checkpoint_state(ckpt) -> dict:
    """{name: tensor} of a `checkpoint:` key: a port checkpoint's EMA weights
    (`cli.common.read_port_checkpoint`) or the bridged JAX `.npz` tree."""
    state = read_port_checkpoint(ckpt)
    return unet_state_dict_from_jax(ckpt) if state is None else state


def load_weights(unet: UNet, ckpt: Optional[str], fresh_init_noise: float, seed: int) -> None:
    """Load `ckpt` (a port checkpoint directory or `.pt` file, whose EMA
    weights are taken, or a flat .npz of the JAX UNet tree) into `unet`, every
    leaf's name and shape checked; a stage-2 tree's learned `logvar` (the
    {"unet", "logvar"} tree) is dropped, as sampling does not read it.
    Without one, keep the fresh init and fill its zero-initialised kernels
    with N(0, fresh_init_noise^2) drawn from `seed`."""
    if ckpt:
        state = _checkpoint_state(ckpt)
        state.pop("logvar", None)
        check_state(dict(unet.named_parameters()), state, f"checkpoint {ckpt!r}")
        unet.load_state_dict(state)
        return
    print("WARNING: no checkpoint configured — sampling with FRESH-INIT (random) weights")
    if fresh_init_noise:
        fill_zero_init(unet, fresh_init_noise, seed)


def load_mask_weights(ms: MaskSampler, ckpt: Optional[str], fresh_init_noise: float, seed: int) -> None:
    """Load `ckpt` (as `load_weights` reads it: the UNet's names, and with a
    text refiner the refiner's as `refiner.<name>`, the {"unet", "refiner"}
    tree of the JAX package) into the UNet and the refiner, every leaf's name
    and shape checked; without one keep the fresh init as `load_weights`
    does."""
    if not ckpt:
        load_weights(ms.unet, None, fresh_init_noise, seed)
        return
    state = _checkpoint_state(ckpt)
    check_state(dict(ms.named_parameters()), state, f"stage-1 checkpoint {ckpt!r}")
    ms.unet.load_state_dict({k: v for k, v in state.items() if not k.startswith("refiner.")})
    if ms.refiner is not None:
        ms.refiner.load_state_dict({k[len("refiner."):]: v for k, v in state.items() if k.startswith("refiner.")})


def load_text_context(tcfg, device) -> Optional[torch.Tensor]:
    """The raw (1, T, D) fp32 text context the `text:` section names: the
    first array of `features_npz` with a batch axis, or the frozen BERT
    features of `prompt` from the model directory `bert_path`; None without
    either."""
    if not isinstance(tcfg, dict):
        return None
    if tcfg.get("features_npz"):
        with np.load(tcfg["features_npz"]) as z:
            return torch.from_numpy(np.asarray(z[z.files[0]], np.float32))[None].to(device)
    if tcfg.get("bert_path"):
        from ..nn.text import FrozenBERTEmbedder

        feats = FrozenBERTEmbedder(tcfg["bert_path"], device=device)(tcfg.get("prompt", ""))
        return torch.from_numpy(feats).to(device)
    return None


def _stage2(cfg: dict, s2: dict, device, seed: int, noise_std: float):
    """(pixel SliceLDM, LatentSliceLDM or None, DDIMParams, sampler options)."""
    ldm = build_slice_ldm(s2, device)
    load_weights(ldm.unet, s2.get("checkpoint"), noise_std, seed + 2)
    latent, _ = build_latent_ldm(s2, ldm, int(s2.get("slice_size", 512)), device, noise_std, seed + 3)
    ddim = DDIMParams.create(ldm.diffusion, int(cfg.get("ddim_steps", 50)),
                             method=cfg.get("ddim_discretize", s2.get("ddim_discretize", "uniform")),
                             eta=float(cfg.get("ddim_eta", 0.0)))
    sample_kw = {"sampler": cfg.get("sampler", s2.get("sampler", "ddim")),
                 "warm_start": cfg.get("warm_start", s2.get("warm_start")),
                 "guidance_scale": float(cfg.get("guidance_scale", s2.get("guidance_scale", 1.0)))}
    return ldm, latent, ddim, sample_kw


def _write_case(cdir: Path, ct: np.ndarray, labels: Optional[np.ndarray], pred: bool) -> None:
    """image.nii.gz and image.png; with labels of the CT's shape overlay.png;
    with `pred` also pred.nii.gz and pred.png."""
    cdir.mkdir(parents=True, exist_ok=True)
    save_image_volume(cdir / "image.nii.gz", ct)
    save_grid_png(cdir / "image.png", image_volume_to_grid(ct))
    if pred:
        save_label_volume(cdir / "pred.nii.gz", labels)
        save_grid_png(cdir / "pred.png", labels_to_grid(labels))
    if labels is not None and labels.shape == ct.shape:
        save_grid_png(cdir / "overlay.png", overlay_volume_to_grid(ct, labels))


def run(cfg: dict, device=None) -> dict:
    """Sample `n_cases` volumes and write them.  `two_stage` returns {"ct":
    (n_cases, D, H, W) float32, "labels": (n_cases, D', H', W') int,
    "seconds": {"stage1", "stage2"}, "output_path": Path}; `ct` and the
    written pred.nii.gz cover the generated slices, `labels` the whole grid.
    `ct` returns {"ct", "seconds": {"stage2"}, "metrics" (the metrics.json
    dict or None), "output_path"}; `mask` what `_run_mask` says."""
    device = resolve_device(cfg.get("device", device))
    configure_precision()
    stage = cfg.get("stage", "two_stage")
    s1, s2 = cfg.get("stage1", cfg), cfg.get("stage2", cfg)
    if "step_T_sample" in cfg and "step_T_sample" not in s1:
        s1 = {**s1, "step_T_sample": cfg["step_T_sample"]}
    _check_stage(cfg, s1, s2, stage)

    outdir = Path(cfg.get("output_path", "samples"))
    outdir.mkdir(parents=True, exist_ok=True)
    seed = int(cfg.get("seed", 1024))
    noise_std = float(cfg.get("fresh_init_noise", 0.0))
    if stage == "ct":
        return _run_ct(cfg, s2, device, seed, noise_std, outdir)
    ms = build_mask_sampler(s1, device)
    spatial = tuple(s1.get("dataset", {}).get("volume_shape", (64, 128, 128)))
    features = build_dino_feature_fn(s1, spatial, device)[:2]  # (feat_fn, inject_idx), the trainer's seed rule
    load_mask_weights(ms, s1.get("checkpoint"), noise_std, seed + 1)
    context = load_text_context(cfg.get("text"), device)
    if stage == "mask":
        return _run_mask(cfg, s1, ms, context, features, device, seed, outdir)
    n_cases = int(cfg.get("n_cases", 1))
    vshape = tuple(cfg.get("volume_shape", (128, 256, 256)))
    n_slices = int(cfg.get("slices", vshape[0]))
    chunk = int(cfg.get("chunk", n_slices))
    if not 0 < n_slices <= vshape[0] or n_slices % chunk:
        raise ValueError(f"slices ({n_slices}) must be in [1, {vshape[0]}] and a multiple of chunk ({chunk})")

    ldm, latent, ddim, sample_kw = _stage2(cfg, s2, device, seed, noise_std)
    if cfg.get("tile") or s2.get("tile"):
        print("WARNING: `tile:` is ignored on two_stage (a `stage: ct` key); sampling untiled")
    noise = NoiseSource(seed, device)
    bs = max(1, min(int(cfg.get("batch_size", 1)), n_cases))
    if bs > 1:
        mesh = make_mesh_for_batch(bs, device=device)
        ms.unet.set_mesh(mesh)
        ldm.unet.set_mesh(mesh)
    cts, labels_all = [], []
    seconds = {"stage1": 0.0, "stage2": 0.0}
    # each case's files are written while the next batch samples
    with torch.inference_mode(), ThreadPoolExecutor(max_workers=2) as writer:
        writes = []
        for c0 in range(0, n_cases, bs):
            b = min(bs, n_cases - c0)
            # zero image condition, as the JAX CLI's two_stage branch
            cond = torch.zeros((b, *spatial, 1), device=device)
            ctx = None if context is None else context.expand(b, -1, -1)
            mask_program, chunk_program = make_chunked_two_stage_programs(
                ms, latent or ldm, mask_shape=(b, *spatial), volume_shape=vshape, ddim=ddim, chunk=chunk,
                mask_steps=cfg.get("mask_steps", 250), cond=cond, context=ctx,
                feature_cond=feature_cond(*features, cond), **sample_kw)
            t0 = time.perf_counter()
            labels, mask_channel = mask_program(noise)
            synchronize(device)
            t1 = time.perf_counter()
            vols, last = [], None
            for z0 in range(0, n_slices, chunk):
                vol, last = chunk_program(noise, mask_channel[:, z0:z0 + chunk], last)
                vols.append(vol)
            ct = torch.cat(vols, dim=1)[..., 0].float().cpu().numpy()
            t2 = time.perf_counter()
            seconds["stage1"] += t1 - t0
            seconds["stage2"] += t2 - t1
            labels = labels.cpu().numpy()
            for j in range(b):
                writes.append(writer.submit(_write_case, outdir / f"case_{c0 + j:04d}", ct[j], labels[j, :n_slices],
                                            pred=True))
            cts.append(ct)
            labels_all.append(labels)
        for w in writes:
            w.result()  # a failed write raises here
    print(f"{n_cases} case(s): stage 1 {seconds['stage1']:.2f}s, stage 2 {seconds['stage2']:.2f}s "
          f"({n_slices} slices x {ddim.num_steps} {sample_kw['sampler']} nodes"
          f"{', latent' if latent is not None else ''}) on {device}")
    return {"ct": np.concatenate(cts), "labels": np.concatenate(labels_all), "seconds": seconds,
            "output_path": outdir}


def _run_mask(cfg: dict, s1: dict, ms: MaskSampler, context: Optional[torch.Tensor], features: tuple, device,
              seed: int, outdir: Path) -> dict:
    """`stage: mask`: per batch of `batch_size` cases (the ragged last batch
    padded by repeating its last case) `samples` label volumes drawn in turn
    from one noise source, with the batch's dense features when `features` =
    (feat_fn, inject_idx) holds an extractor; per case its files, the mean
    foreground Dice of the first draw against the dataset's mask, and with `samples` > 1 GED and
    HM-IoU over the draws.  Returns {"labels": (n_cases, samples, D, H, W),
    "metrics": per case {"dice", "ged", "hm_iou"}, "seconds": {"stage1"},
    "output_path"}."""
    n_cases, n_rep = int(cfg.get("n_cases", 1)), int(cfg.get("samples", 1))
    ds = build_mask_dataset(s1, cfg.get("split", "val"))
    spatial = ds.volume_shape
    bs = int(cfg.get("batch_size", 1))
    if bs > 1:
        ms.unet.set_mesh(make_mesh_for_batch(bs, device=device))
    nc = ms.num_classes
    noise = NoiseSource(seed, device)
    labels_all, metrics, seconds = [], [], 0.0
    t_start = time.perf_counter()
    with torch.inference_mode():
        for c0 in range(0, n_cases, bs):
            cases = list(range(c0, min(c0 + bs, n_cases)))
            items = [ds[i % len(ds)] for i in cases]
            images = [items[j if j < len(items) else -1]["image"] for j in range(bs)]
            cond = torch.from_numpy(np.stack(images)).to(device)
            ctx = None if context is None else context.expand(bs, -1, -1)
            t0 = time.perf_counter()
            fc = feature_cond(*features, cond)
            draws = [ms.sample_labels(noise, (bs, *spatial), cond=cond, context=ctx, feature_cond=fc,
                                      num_steps=cfg.get("mask_steps", 250)) for _ in range(n_rep)]
            synchronize(device)
            seconds += time.perf_counter() - t0
            draws = np.stack([d.cpu().numpy() for d in draws], axis=1)  # (bs, samples, D, H, W)
            for j, i in enumerate(cases):
                cdir = outdir / f"case_{i:04d}"
                cdir.mkdir(parents=True, exist_ok=True)
                pred, gt = draws[j, 0], np.argmax(items[j]["mask"], -1)
                save_label_volume(cdir / "pred.nii.gz", pred)
                save_grid_png(cdir / "pred.png", labels_to_grid(pred))
                save_label_volume(cdir / "gt.nii.gz", gt)
                dice = float(per_class_dice(torch.from_numpy(pred), torch.from_numpy(gt), nc)[1:].mean())
                m = {"dice": dice}
                msg = f"case {i}: mean fg dice {dice:.4f}"
                if n_rep > 1:
                    m["ged"] = generalized_energy_distance(draws[j], gt[None], nc)
                    m["hm_iou"] = hungarian_matched_iou(draws[j], np.stack([gt] * n_rep), nc)
                    msg += f" GED {m['ged']:.4f} HM-IoU {m['hm_iou']:.4f}"
                print(msg)
                metrics.append(m)
            labels_all.append(draws[:len(cases)])
    dt = time.perf_counter() - t_start
    print(f"{n_cases} case(s) in {dt:.1f}s ({dt / max(n_cases, 1):.1f}s/case; stage 1 {seconds:.2f}s, "
          f"{n_rep} draw(s) x {cfg.get('mask_steps', 250)} steps) on {device}")
    return {"labels": np.concatenate(labels_all), "metrics": metrics, "seconds": {"stage1": seconds},
            "output_path": outdir}


def _fvd_summary(cfg: dict, real, generated, device) -> dict:
    """FVD over the case set, with the port's I3D when `i3d_weights` names a
    converted `.npz`, else the uncalibrated pyramid features (not comparable
    to published I3D FVD scores, which the extractor's name says)."""
    weights = cfg.get("i3d_weights")
    extractor = "i3d" if weights else "pyramid-uncalibrated"
    value = fvd(real, generated, feature_fn=i3d_npz_feature_fn(weights, device) if weights else None)
    return {"fvd": float(value), "fvd_feature_extractor": extractor, "fvd_backbone": extractor}


def _run_ct(cfg: dict, s2: dict, device, seed: int, noise_std: float, outdir: Path) -> dict:
    """`stage: ct`: per case the dataset's mask volume -> a CT volume, its
    files, and the three-view LPIPS against the dataset's volume; over two or
    more such cases FVD (`_fvd_summary`)."""
    n_cases = int(cfg.get("n_cases", 1))
    ldm, latent, ddim, sample_kw = _stage2(cfg, s2, device, seed, noise_std)
    tcfg = cfg.get("tile") or s2.get("tile")
    tile = None
    if tcfg and latent is not None:
        print("WARNING: `tile:` is ignored on the latent ct path "
              "(latents are already small; first-stage tiling is built in)")
    elif tcfg:
        tile = (tuple(tcfg["patch"]), tuple(tcfg.get("stride", tcfg["patch"])))
    ds = build_slice_dataset(s2, cfg.get("split", "val"))
    nc = int(cfg.get("num_classes", s2.get("num_classes", 12)))
    noise = NoiseSource(seed, device)
    lp_metric, lpips_vals, cts, gt_vols, metric_cases, seconds = None, [], [], [], [], 0.0
    with torch.inference_mode():
        for i in range(n_cases):
            item = ds[i % len(ds)]
            depth = item["wholemask"].shape[0]
            n = int(cfg.get("slices", depth))
            if not 0 < n <= depth:
                raise ValueError(f"slices ({n}) must be in [1, {depth}]")
            mask = torch.from_numpy(item["wholemask"][:n]).to(device)[None]
            t0 = time.perf_counter()
            if latent is not None:
                vol = latent.sample_volume(noise, mask, ddim, **sample_kw)
            else:
                vol = ldm.sample_volume(noise, mask, ddim, tile=tile, **sample_kw)
            vol = vol[0, ..., 0].float().cpu().numpy()
            seconds += time.perf_counter() - t0
            labels = np.rint(item["wholemask"][:n, ..., 0] * (nc - 1)).astype(np.int64)
            _write_case(outdir / f"case_{i:04d}", vol, labels, pred=False)
            cts.append(vol)
            gt = item.get("wholeimage")
            if cfg.get("metrics", True) and gt is not None and gt[:n].shape[:-1] == vol.shape:
                if lp_metric is None:
                    from ..eval.lpips import LPIPS

                    lp_metric = LPIPS(cfg.get("lpips_weights"), device=device)
                    if not cfg.get("lpips_weights"):
                        print("NOTE: lpips_weights not configured — LPIPS uses an "
                              "uncalibrated VGG (relative comparisons only)")
                from ..eval.lpips import lpips_three_view

                gt_vols.append(np.ascontiguousarray(gt[:n, ..., 0]))
                val = float(lpips_three_view(lp_metric, torch.from_numpy(vol), torch.from_numpy(gt_vols[-1])))
                lpips_vals.append(val)
                metric_cases.append(i)
                print(f"case {i}: lpips_3view {val:.4f}")
    summary = None
    if lpips_vals:
        summary = {"lpips_three_view_mean": float(np.mean(lpips_vals)), "lpips_per_case": lpips_vals}
        if len(gt_vols) >= 2:
            summary.update(_fvd_summary(cfg, gt_vols, [cts[i] for i in metric_cases], device))
        (outdir / "metrics.json").write_text(json.dumps(summary, indent=1))
        print("metrics:", {k: v for k, v in summary.items() if k != "lpips_per_case"})
    print(f"{n_cases} case(s): stage 2 {seconds:.2f}s ({cts[0].shape[0]} slices x {ddim.num_steps} "
          f"{sample_kw['sampler']} nodes{', latent' if latent is not None else ''}) on {device}")
    return {"ct": np.stack(cts), "seconds": {"stage2": seconds}, "metrics": summary, "output_path": outdir}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    run(load_yaml_config(argv[0], overrides=argv[1:]))


if __name__ == "__main__":
    main()
