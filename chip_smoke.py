#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`jointimagegeneration_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a CUDA card

Phases, in order (any failure exits non-zero and prints no result line):
  1. build: compiles every CUDA source of the main paths with nvcc
     (flash_fwd.cu, flash_bwd.cu, conv3d.cu), one nvcc per source, all
     started together;
  2. kernels: each kernel against its plain PyTorch version on the card at the
     main paths' shapes (max abs error against a stated tolerance), timed as
     many calls in one CUDA graph (device time, host launch cost excluded;
     the eager back-to-back time is kept beside it as `eager_ms`) beside the
     plain version, one PyTorch library call computing the same function
     (`library_ms`) and the card's bound; then checked, not timed, at ragged
     and wide-head shapes off the main paths.  The flash forward (error, a
     bitwise repeat, the launch plan taken; the fp32 rows with their key
     splits and merge, and the merge alone on the refiner rows' splits,
     `flash_fwd_merge ...`, its bound the bytes that must cross HBM, O and
     LSE written, as the backward's split reduce's the sum written), then the
     flash backward (dkv and dq kernels) at the training shapes, then the
     3x3x3 conv kernel (`conv3d ...` lines: error, a bitwise repeat, the
     launch plan taken) at the fused and pallas_conv paths' shapes, bf16 and
     fp32 (library: F.conv3d, TF32 off), then checked at every distinct conv
     of the fused path, in bf16 and fp32, and at its edge shapes.  The flash rows include the text-guided stage 1's
     (CROSS_SHAPES: cross-attention over 4, 128, 512 and 640 context tokens in
     bf16, the refiner's 512- and 640-token self-attention in fp32 at D = 64);
     the fp32 backward rows also time the split reduce (`flash_bwd_reduce`)
     and hold it against its plain version, and the backward's edge shapes
     include ragged fp32 splits;
  3. reference: a tiny two-stage pipeline on the card against the same
     pipeline on the CPU (same weights, same noise);
  4. sampler reference: the stage-2 sampler routes of a tiny fp32 SliceLDM
     (32x32 slices, T = 1024 at its attention sites) on the card against the
     CPU (`sampler reference (...)` lines): DPM and PLMS volumes with and
     without warm start, DDIM with guidance, inpaint, outpaint, a tiled
     48x48 slice, and at T = 20 p_sample_loop, progressive_denoising and
     log_images; then stream_volume against sample_volume, bit for bit;
     latent reference: the latent `_ae` route on a tiny fp32 LatentSliceLDM
     (KL-VAEs at 64x64, a 32x32x4 latent, T = 1024 at the UNet's sites) on
     the card against the CPU (`latent reference (...)` lines): DDIM, DPM
     with warm start, DDIM with guidance, a latent two-stage run in chunks,
     stream against sample; then an AE whose mid attention has one head of
     288 (past the flash rule's 256): card against CPU, no flash launch;
  5. fused reference: tiny fp32 fused MaskSamplers ('kernel' and 'xla') and
     one fp32 fused ResBlock's forward and backward on the card against the
     CPU (`fused reference ...` lines);
  6. path: `cli.sample.run` on `configs/sample_two_stage.yml`'s full widths
     (stage 1 64x128x128 at base 64, stage 2 256x256 at base 128, bf16), with
     only the lengths cut: 4 mask steps, the full 128x256x256 handoff, and two
     chunks of 2 slices with the full DDIM-50 chain;
     fast path: the path's run again (warm), then `cli.sample.run` on
     `configs/sample_two_stage_fast.yml`, cut only in slices (25 mask steps,
     4 slices in one chunk, DPM-Solver++(2M) at 20 uniform-lambda nodes),
     then the variant with PLMS, warm start 0.4 and guidance 2.0; stage-2
     s/slice beside the DDIM-50 path's;
     tiled path: `SliceLDM.sample_volume` at 512x512, tiled in 256x256
     windows at stride 128 (9 windows), one slice, DDIM-4;
     latent path: `cli.sample.run` on `configs/sample_ct_ae.yml`'s full
     widths (KL-VAEs ch 128 / 96 at 512x512 in fp32, the base-160 UNet in
     bf16 on the 64x64x4 latent, DDIM-50), cut to 4 slices: 1,000 flash
     launches (its five ds-2 sites), s/slice by cond encode, chain and
     decode, the AEs' TFLOP and rate, peak GiB, LPIPS in metrics.json;
  7. fused path: the same stage-1 sampler built with
     use_fused_resblock='kernel', 'xla' and use_pallas_conv=True, 4 steps
     each beside the unfused model, same weights and draws: s/step, launch
     counts (per step fused: 54 conv, 27 stats-reduce and a split-K reduce
     for each conv the launch planner splits; 8 conv under pallas_conv) and
     probabilities against an fp32 forward (`fused path ...`); then the
     'kernel' path in fp32 (`bf16: false`, the fp32 conv kernel), 2 steps:
     s/step, peak GiB, the conv device ms per UNet level, the fp32 planner's
     launches, probabilities within 1e-4 of the fp32 unfused forward's;
  8. train reference: three fp32 stage-1 train steps of a small UNet (T = 512
     at its attention sites, so the card runs the kernels) on the card against
     the same steps on the CPU: loss, every gradient and the params after
     each step;
  9. train path: `cli.train_mask.run` on `configs/stage1_mask.yml`'s full
     widths (64x128x128, 12 classes, base 64, bf16, AdamW, EMA), with only the
     lengths cut: 6 steps with checkpoints at 3 and 6 and one validation at 6,
     then a resumed run to step 8;
 10. text: a tiny fp32 text-conditioned MaskSampler (self-, cross- and
     refiner attention all at 512 tokens) on the card against the CPU,
     guided `sample_labels`, two train steps with the refiner's dropout, each
     from the init, and the second step again from the card's parameters
     after its first (`text reference`); `cli.sample.run` with `stage: mask` at full width,
     `selfattn` (embed 768) and a seeded 512-token features file, 2 draws of
     4 steps with GED and HM-IoU (`text mask path`); the two-stage path with
     the same text over 2 slices (`text two-stage path`); the train path
     with `selfattn` on 4-token synthetic contexts, the refiner in the
     state (`text train path`; its checkpoints deleted at the end); then
     on a 640-token report (a 512- and a 128-token BERT chunk), so the
     refiner's 8 attention sites run the fp32 flash kernels, forward and
     backward with their split reduces: 3 steps, one checkpoint, no
     validation or resume (`text long-report train path`), its s/step, peak
     GiB and the fp32 backward's device ms per step beside the 4-token
     path's;
 11. ldm train reference: three fp32 stage-2 train steps of a small 2D
     SliceLDM with a learned logvar (T = 1024 at its attention sites, so the
     card runs the flash kernels) on the card against the same steps on the
     CPU: loss, every gradient and the params after each step;
 12. ldm train path: `cli.train_ldm.run` on `configs/stage2_ldm.yml`'s full
     widths (512x512 slices, base 128, mult (1,2,4,4,5), bf16, AdamW, LitEma
     EMA), with only the lengths cut: 6 steps with checkpoints at 3 and 6 and
     one validation at 6 (the panels of 2 slices: three DDIM-20 chains,
     written as PNGs; then the val loss at t = T/2), then a resumed run to
     step 8; its ~2.8 GB checkpoints are deleted at the end;
 13. real data: 3 abdominal CT cases (96 x 512 x 512 int16 HU, TotalSegmentator
     and crcseg volumes, 128-token text features) written as NIfTI with the
     port's writer, indexed by `cli.build_index` and laid out as an nnUNet
     tree; the host seconds of a train item of each dataset kind; then
     `cli.train_mask.run` (text-guided, full width) for 2 steps and a
     validation on the val case, `stage: mask` from its `checkpoints/`
     (labels equal to a by-hand load of the EMA weights), `cli.train_ldm.run`
     on `ruijin` (full width, 512x512) for 2 steps and a validation, `stage:
     ct` from its `checkpoints/` (2 slices, DDIM-50, LPIPS against the case's
     CT), and `cli.train_ldm.run` on `nnunet` for 2 steps: s/step, the
     seconds each step waited on the loader, peak GiB; every file deleted at
     the end.
Before each main path (6 per run and the latent path, 7 per variant, 9, each
text path of 10, 12, each run of 13) every kernel launch counter (flash_fwd,
flash_fwd_merge, flash_bwd_dkv, flash_bwd_dq, flash_bwd_reduce and the conv
kernel's) is set to 0;
after it the counts must equal what the path implies.  The last lines are
the sampling, latent, fused, train, text and real-data summaries, a JSON line
with the kernel numbers, the card's name and power limit, and `{"ok": true,
"device": {...}}`.  Imports neither JAX nor PyYAML.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM: bf16 tensor cores; fp32 FMA
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
EX2_PER_CLK = 16 * 132  # H100 SXM: MUFU.EX2 results per clock, 16 per SM on 132 SMs
# flash kernel tolerances against its plain version (max abs).  O's limit is
# relative to the plain output's largest |O|: the kernel rounds O, and in bf16
# also P before P.V, to the input dtype, so bf16 O differs by a bf16 ulp or two
# at max|O| (an ulp is 2^-8 to 2^-7 of a value); the limit is 2^-6 of max|O|.
# fp32 O and the fp32 LSE differ only in summation order and exp's rounding.
O_REL_TOL = {torch.bfloat16: 4 * 2**-8, torch.float32: 1e-4}
LSE_TOL = 1e-4
# flash backward tolerances against its plain version: max abs error of each
# of dQ, dK, dV within this fraction of that gradient's max |plain|, the
# forward's rule.  The kernels round P and dS to bf16 where the plain version
# does, but sum in another order, and one rounding of a product of order the
# gradient's scale moves the bf16 result by an ulp (2^-8 to 2^-7 of a value).
BWD_REL_TOL = {torch.bfloat16: 2**-6, torch.float32: 1e-4}
FWD_SHAPES = [  # (BH, T, D), dtype, where the main paths run it
    ((8, 2048, 32), torch.bfloat16, "stage 1 ds8, 64x128x128"),
    ((16, 1024, 32), torch.bfloat16, "stage 2 ds8, 256x256"),
    ((16, 4096, 32), torch.bfloat16, "stage 2 ds8, 512x512"),
    ((8, 2048, 32), torch.float32, "fp32 torso"),
    ((20, 1024, 32), torch.bfloat16, "stage 2 ds16, 512x512"),
    ((32, 4096, 32), torch.bfloat16, "stage 2 ds8, 512x512 validation, b = 2"),
    ((40, 1024, 32), torch.bfloat16, "stage 2 ds16, 512x512 validation, b = 2"),
    ((10, 1024, 32), torch.bfloat16, "latent stage 2 ds2, 64x64 latent (configs/sample_ct_ae.yml)"),
]
FWD_EDGE_SHAPES = [  # (BH, Tq, Tk, D), dtype: ragged T, Tq != Tk, every head width, D padded
    ((3, 100, 77, 40), torch.bfloat16), ((2, 130, 200, 256), torch.bfloat16), ((2, 1088, 1088, 16), torch.bfloat16),
    ((3, 100, 77, 40), torch.float32), ((2, 130, 70, 256), torch.float32), ((1, 7, 3, 5), torch.float32),
    ((2, 130, 40, 40), torch.bfloat16),  # Tk <= 64: two warpgroups, one of which sees no key
    ((1, 7, 3, 5), torch.bfloat16), ((2, 300, 200, 64), torch.bfloat16), ((1, 64, 64, 128), torch.bfloat16),
    # fp32 splits: a ragged last key tile, uneven split ranges, one key tile per split, 4097 keys
    ((3, 1000, 77, 40), torch.float32), ((2, 77, 1000, 64), torch.float32), ((1, 65, 4097, 16), torch.float32),
    ((2, 64, 64, 128), torch.float32),
]
# (BH, Tq, Tk, D), dtype, where: the text-guided stage-1 paths (8 heads of 32
# at the five ds-8 sites of 8x16x16 = 2,048 tokens; the refiner 8 heads of 64
# in fp32), forward and backward
CROSS_SHAPES = [
    ((8, 2048, 4, 32), torch.bfloat16, "stage 1 ds8 cross-attention, synthetic context"),
    ((8, 2048, 128, 32), torch.bfloat16, "stage 1 ds8 cross-attention, the real-data index's 128-token features"),
    ((8, 2048, 512, 32), torch.bfloat16, "stage 1 ds8 cross-attention, a 512-token report"),
    ((8, 2048, 640, 32), torch.bfloat16, "stage 1 ds8 cross-attention, a 640-token report"),
    ((8, 512, 512, 64), torch.float32, "text refiner, a 512-token report"),
    ((8, 640, 640, 64), torch.float32, "text refiner, a 640-token report"),
]
BWD_SHAPES = [  # (BH, T, D), dtype, where training runs it
    ((8, 2048, 32), torch.bfloat16, "stage 1 ds8, 64x128x128"),
    ((16, 1024, 32), torch.bfloat16, "stage 2 ds8, 256x256"),
    ((16, 4096, 32), torch.bfloat16, "stage 2 ds8, 512x512 (configs/stage2_ldm.yml)"),
    ((20, 1024, 32), torch.bfloat16, "stage 2 ds16, 512x512"),
    ((8, 2048, 32), torch.float32, "fp32 torso"),
]

TWO_STAGE_CFG = {  # configs/sample_two_stage.yml, lengths cut
    "stage": "two_stage",
    "seed": 1024,
    "n_cases": 1,
    "mask_steps": 4,
    "ddim_steps": 50,
    "ddim_eta": 0.0,
    "volume_shape": [128, 256, 256],
    "chunk": 2,
    "slices": 4,
    "fresh_init_noise": 0.02,
    "stage1": {
        "num_classes": 12,
        "time_steps": 1000,
        "beta_schedule": "cosine",
        "bf16": True,
        "unet_openai": {"base_channels": 64, "channel_mult": [1, 2, 2, 4, 5],
                        "attention_resolutions": [32, 16, 8], "num_head_channels": 32},
        "dataset": {"kind": "synthetic", "volume_shape": [64, 128, 128]},
    },
    "stage2": {
        "slice_size": 256,
        "channels": 1,
        "cond_channels": 2,
        "timesteps": 1000,
        "linear_start": 0.0015,
        "linear_end": 0.0195,
        "bf16": True,
        "unet_config": {"params": {"model_channels": 128, "channel_mult": [1, 2, 4, 4, 5],
                                   "attention_resolutions": [32, 16, 8], "num_head_channels": 32}},
    },
}

FAST_CFG = {  # configs/sample_two_stage_fast.yml (DPM-Solver++(2M), 20 uniform-lambda nodes), slices cut
    **TWO_STAGE_CFG,
    "mask_steps": 25,
    "ddim_steps": 20,
    "ddim_discretize": "uniform_lambda",
    "sampler": "dpm",
    "chunk": 4,  # one chunk: warm start carries across all the slices
    "slices": 4,
}
FAST_VARIANT = {"sampler": "plms", "warm_start": 0.4, "guidance_scale": 2.0}

STAGE1_TRAIN_CFG = {  # configs/stage1_mask.yml, lengths cut
    "seed": 0,
    "num_classes": 12,
    "time_steps": 1000,
    "beta_schedule": "cosine",
    "bf16": True,
    "remat": False,
    "batch_size": 1,
    "max_steps": 6,
    "save_freq": 3,
    "display_freq": 1,
    "validation_freq_steps": 6,
    "class_weights": "uniform",
    "polyak_alpha": 0.9999,
    "eval_time_steps": 4,
    "n_validation_images": 1,
    "optim": {"name": "AdamW", "learning_rate": 1.0e-3, "lr_function": "polynomial",
              "lr_params": {"power": 1.0, "min_lr": 1.0e-6}},
    "unet_openai": TWO_STAGE_CFG["stage1"]["unet_openai"],
    "feature_cond_encoder": {"type": "none"},
    "dataset": {"kind": "synthetic", "volume_shape": [64, 128, 128], "num_cases": 16},
}
STAGE2_TRAIN_CFG = {  # configs/stage2_ldm.yml, lengths cut
    "seed": 0,
    "scale_lr": True,
    "batch_size": 1,
    "accumulate_grad_batches": 1,
    "max_steps": 6,
    "save_freq": 3,
    "display_freq": 1,
    "eval_every": 6,
    "n_log_images": 2,
    "model": {
        "base_learning_rate": 2.0e-06,
        "timesteps": 1000,
        "beta_schedule": "linear",
        "linear_start": 0.0015,
        "linear_end": 0.0195,
        "channels": 1,
        "cond_channels": 2,
        "bf16": True,
        "unet_config": {"params": {"model_channels": 128, "channel_mult": [1, 2, 4, 4, 5],
                                   "attention_resolutions": [32, 16, 8], "num_res_blocks": 2,
                                   "num_head_channels": 32}},
    },
    "dataset": {"kind": "synthetic", "slice_shape": [512, 512], "depth": 16, "num_cases": 16},
}
LATENT_CT_CFG = {  # configs/sample_ct_ae.yml, depth cut to 4 slices
    "stage": "ct",
    "seed": 1024,
    "n_cases": 1,
    "ddim_steps": 50,
    "fresh_init_noise": 0.02,
    "stage2": {
        "slice_size": 512,
        "timesteps": 1000,
        "beta_schedule": "linear",
        "linear_start": 0.0015,
        "linear_end": 0.0195,
        "channels": 4,
        "cond_channels": 4,
        "bf16": True,
        "unet_config": {"params": {"model_channels": 160, "channel_mult": [1, 2, 4, 4, 5],
                                   "attention_resolutions": [8, 4, 2], "num_res_blocks": 2,
                                   "num_head_channels": 32}},
        "first_stage": {"embed_dim": 4, "ddconfig": {"ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
                                                     "attn_resolutions": [16, 8], "z_channels": 4, "in_channels": 1,
                                                     "out_ch": 1, "resolution": 512}},
        "cond_stage": {"embed_dim": 4, "ddconfig": {"ch": 96, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
                                                    "attn_resolutions": [16, 8], "z_channels": 4, "in_channels": 2,
                                                    "out_ch": 2, "resolution": 512}},
        "dataset": {"kind": "synthetic", "slice_shape": [512, 512], "depth": 4, "num_cases": 2},
    },
}
# text-guided stage 1: `feature_cond_encoder: {type: selfattn, embed_dim: 768}`
# in the stage-1 section, the refiner at build_feature_cond_encoder's defaults
# (4 blocks of 8 heads x 64, dropout 0.2); the text paths read a seeded
# (512, 768) fp32 features file, one BERT chunk of a report
TEXT_FCE = {"type": "selfattn", "embed_dim": 768}
TEXT_TOKENS = 512
TEXT_STAGE1 = {**TWO_STAGE_CFG["stage1"], "feature_cond_encoder": TEXT_FCE}
TEXT_MASK_CFG = {"stage": "mask", "seed": 1024, "n_cases": 1, "samples": 2, "mask_steps": 4,
                 "fresh_init_noise": 0.02, "stage1": TEXT_STAGE1}
TEXT_TWO_STAGE_CFG = {**TWO_STAGE_CFG, "slices": 2, "chunk": 2, "stage1": TEXT_STAGE1}
TEXT_TRAIN_CFG = {**STAGE1_TRAIN_CFG, "feature_cond_encoder": TEXT_FCE}
# text-guided stage 1 on a long report: one full 512-token BERT chunk and a
# 128-token one, concatenated as FrozenBERTEmbedder does (a multiple of 128,
# so the refiner's attention takes the fp32 flash kernels); 3 steps, one
# checkpoint, no validation and no resume, to keep the smoke's length
LONG_TEXT_TOKENS = 640
TEXT_LONG_TRAIN_CFG = {**TEXT_TRAIN_CFG, "max_steps": 3, "save_freq": 3, "validation_freq_steps": 1000,
                       "dataset": {**STAGE1_TRAIN_CFG["dataset"], "context_len": LONG_TEXT_TOKENS}}
# the tiny text model of the text reference phase: the train reference's UNet
# (512 tokens at its ds-1 sites) cross-attending over a 512-token context that
# a 2-block refiner of 2 heads x 64 refines, so the self-, cross- and refiner
# attention all take the flash kernels (the refiner's in fp32 at D = 64)
TEXT_REF_FCE = {"type": "selfattn", "embed_dim": 128, "n_heads": 2, "d_head": 64, "model_depth": 2, "dropout": 0.2}
# the tiny KL-VAEs of the latent reference phase: 64x64 pixels, a 32x32
# latent, one 'vanilla' attention placed at resolution 32 besides the mid one
LATENT_REF_AE = {"embed_dim": 4, "ddconfig": {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1,
                                              "attn_resolutions": [32], "z_channels": 4, "resolution": 64}}
# the small 2D UNet of the ldm train reference phase (base 64 for the reason
# below; a 32x32 image puts T = 1024 at its ds-1 and mid attention sites)
LDM_REF_UNET = {"model_channels": 64, "channel_mult": [1], "attention_resolutions": [1], "num_res_blocks": 1,
                "num_head_channels": 16}
# the small UNet of the train reference phase: at base <= 32 every GroupNorm
# group holds one channel, and the bias added before such a norm has a
# gradient of exactly zero, whose rounding noise has no relative error to hold
TRAIN_REF_UNET = {"base_channels": 64, "channel_mult": [1, 2], "attention_resolutions": [1],
                  "num_res_blocks": 1, "num_head_channels": 16}
TRAIN_REF_TOL = 1e-4  # card vs CPU, fp32: of each tensor's max |CPU value|


# the real data phase: an index of 3 abdominal CT cases (96 slices of 512x512
# int16 HU, a uint8 TotalSegmentator volume, a crcseg tumour mask, (128, 768)
# text features each), which the split gives as 2 train cases and 1 val case,
# and the same cases as an nnUNet tree; stage 1 and stage 2 train on them at
# configs/stage1_mask.yml's and configs/stage2_ldm.yml's widths, 2 steps and a
# validation each, and `stage: mask` / `stage: ct` sample the val case from
# the checkpoints they write
REAL_SHAPE = (96, 512, 512)
REAL_TOKENS = 128
TOTALSEG_IDS = (1, 2, 3, 5, 6, 10, 55, 56, 57, 104)  # classes 1..10
BACKGROUND_IDS = (7, 200)  # TotalSegmentator ids that no class takes
REAL_STAGE1 = {**STAGE1_TRAIN_CFG, "max_steps": 2, "save_freq": 2, "validation_freq_steps": 2,
               "feature_cond_encoder": TEXT_FCE, "dataset": {"kind": "ruijin", "volume_shape": [64, 128, 128]}}
REAL_STAGE2 = {**STAGE2_TRAIN_CFG, "max_steps": 2, "save_freq": 2, "eval_every": 2,
               "dataset": {"kind": "ruijin", "slice_shape": [512, 512]}}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (`nvidia-smi --query-gpu=clocks.max.sm`)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def time_ms(fn, iters: int, reps: int = 5) -> tuple:
    """(device ms, eager ms) per call of `fn`.  Device: `iters` calls captured
    in one CUDA graph and replayed `reps` times between CUDA events, so the
    host's per-call cost (checks, allocation, launch) is out of the reading.
    Eager: the same calls issued back to back from Python, host included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as graph capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters), eager_ms


def merge_row(flash, g, bh: int, t: int, d: int) -> dict:
    """The fp32 forward's split merge (`flash_fwd_merge`) at the plan's splits
    of a (bh, t, t, d) forward, on seeded partial states (m ~ N(0, 1), l in
    [0.5, 1.5), O ~ N(0, 1)): error against its plain version, a bitwise
    repeat, graph-timed ms beside the plain version's, and its bound: the
    bytes that must cross HBM, O and LSE written once, at PEAK_BYTES.  The
    workspace is left out: the forward kernel writes it just before, and it
    is read back from L2 (`all_bytes_hbm_ms` counts it too, at HBM's rate,
    as if it were not).  No one PyTorch call computes the merge."""
    splits = flash.plan_flash_fwd(bh, t, t, d, torch.float32).splits
    o_parts = torch.randn((splits, bh, t, d), generator=g, device="cuda")
    ml = torch.stack([torch.randn((splits, bh, t), generator=g, device="cuda"),
                      torch.rand((splits, bh, t), generator=g, device="cuda") + 0.5], dim=-1)
    o, lse = torch.empty((bh, t, d), device="cuda"), torch.empty((bh, t, 1), device="cuda")
    flash.flash_fwd_merge(o_parts, ml, o, lse)
    o2, lse2 = flash.flash_fwd_merge(o_parts, ml, torch.empty_like(o), torch.empty_like(lse))
    torch.cuda.synchronize()
    check(torch.equal(o, o2) and torch.equal(lse, lse2), f"flash_fwd_merge: two calls differ at {(bh, t, d)}")
    want_o, want_lse = flash.flash_fwd_merge_plain(o_parts, ml)
    err = max((o - want_o).abs().max().item(), (lse - want_lse).abs().max().item())
    tol = O_REL_TOL[torch.float32] * want_o.abs().max().item()
    check(err <= tol, f"flash_fwd_merge disagrees at {(bh, t, d)}: {err} (tol {tol})")
    ms, eager_ms = time_ms(lambda: flash.flash_fwd_merge(o_parts, ml, o, lse), 20)
    plain_ms, _ = time_ms(lambda: flash.flash_fwd_merge_plain(o_parts, ml), 20)
    out_bytes = (o.numel() + lse.numel()) * 4
    all_bytes = out_bytes + (o_parts.numel() + ml.numel()) * 4
    row = {"shape": [bh, t, t, d], "splits": splits, "max_abs_err": err, "tol": tol, "ms": ms, "eager_ms": eager_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": out_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "all_bytes_hbm_ms": all_bytes / PEAK_BYTES * 1e3}
    print(f"flash_fwd_merge {[bh, t, t, d]} fp32, {splits} splits: err {err:.3g} (tol {tol:.3g}), repeat bitwise "
          f"equal; graph-timed {ms:.4f} ms (eager {eager_ms:.4f}), plain {plain_ms:.4f} ms; bound {row['bound_ms']:.4f} "
          f"ms (O and LSE, {out_bytes / 1e6:.2f} MB, written at HBM's rate; with the {all_bytes / 1e6:.2f} MB "
          f"workspace read too {row['all_bytes_hbm_ms']:.4f}), {100 * row['bound_ms'] / ms:.1f}% of bound", flush=True)
    return row


def compare(flash, q, k, v, label: str) -> tuple:
    """Max abs error of the kernel against its plain version on the same
    inputs, (O, LSE); fails past the stated tolerances, and unless a second
    call gives bitwise-equal O and LSE (no atomics, a fixed merge order)."""
    o, lse = flash.flash_forward(q, k, v)
    o2, lse2 = flash.flash_forward(q, k, v)
    torch.cuda.synchronize()
    check(torch.equal(o, o2) and torch.equal(lse, lse2), f"flash_fwd: two calls differ at {label}")
    check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()), f"flash_fwd: not finite at {label}")
    po, plse = flash.flash_attention_plain(q, k, v)
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    tol_o = O_REL_TOL[q.dtype] * po.float().abs().max().item()
    check(err_o <= tol_o and err_lse <= LSE_TOL,
          f"flash_fwd disagrees at {label}: O {err_o} (tol {tol_o}), LSE {err_lse} (tol {LSE_TOL})")
    return err_o, err_lse, tol_o


def _full_shapes(shapes) -> list:
    """FWD_SHAPES / BWD_SHAPES rows as (BH, Tq, Tk, D) rows, then CROSS_SHAPES."""
    return [((bh, t, t, d), dtype, where) for (bh, t, d), dtype, where in shapes] + CROSS_SHAPES


def flash_phase(flash) -> list:
    """The flash forward at the main paths' shapes (CROSS_SHAPES with Tq !=
    Tk among them): error, a bitwise repeat, times (graph-timed, eager,
    plain, SDPA) and bounds, the largest of three times: the products on the
    tensor cores (`tensor_bound_ms`, 4*BH*Tq*Tk*D flops; fp32 on the FMA
    pipes), the BH*Tq*Tk exponentials at EX2_PER_CLK per clock of the card's
    maximum SM clock (`exp_bound_ms`), and the bytes (q, k, v read, O and LSE
    written once).  Then checked, not timed, at the edge shapes."""
    import torch.nn.functional as F

    ex2_per_s = EX2_PER_CLK * max_sm_clock_hz()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows = []
    for (bh, t, tk, d), dtype, where in _full_shapes(FWD_SHAPES):
        q = (torch.randn(bh, t, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
        k = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
        dname = str(dtype).replace("torch.", "")
        err_o, err_lse, tol_o = compare(flash, q, k, v, f"{(bh, t, tk, d)} {dname}")
        plan = flash.plan_flash_fwd(bh, t, tk, d, dtype)
        ms, eager_ms = time_ms(lambda: flash.flash_forward(q, k, v), 50)  # fp32: with the merge where it splits
        plain_ms, _ = time_ms(lambda: flash.flash_attention_plain(q, k, v), 10)
        q4, k4, v4 = q[None], k[None], v[None]
        library_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), 50)
        t_ms = 4.0 * bh * t * tk * d / PEAK_FLOPS[dtype] * 1e3
        exp_ms = bh * t * tk / ex2_per_s * 1e3
        b_ms = (2 * bh * (t + tk) * d * q.element_size() + bh * t * 4) / PEAK_BYTES * 1e3
        bound_ms = max(t_ms, exp_ms, b_ms)
        limit = "bytes" if b_ms == bound_ms else ("ex2" if exp_ms > t_ms else "tensor")
        row = {"shape": [bh, t, tk, d], "dtype": dname, "where": where,
               "err_o": err_o, "tol_o": tol_o, "err_lse": err_lse, "ms": ms, "eager_ms": eager_ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if limit == "bytes" else "operations", "limit": limit,
               "tensor_bound_ms": t_ms, "exp_bound_ms": exp_ms,
               "plan": [plan.warpgroups, plan.smem_bytes, plan.splits, plan.grid]}
        print(f"flash_fwd {row['shape']} {dname} ({where}): err O {err_o:.3g} (tol {tol_o:.3g}) "
              f"LSE {err_lse:.3g}, repeat bitwise equal; graph-timed kernel {ms:.4f} ms (eager {eager_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({limit}; "
              f"{'tensor' if dtype == torch.bfloat16 else 'fma'} {t_ms:.4f}, ex2 {exp_ms:.4f}), "
              f"{100 * bound_ms / ms:.1f}% of bound; plan (warpgroups, smem bytes, splits, blocks) {row['plan']}",
              flush=True)
        rows.append(row)
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    # correctness only: shapes the eligibility rule admits off the main path
    for (bh, tq, tk, d), dtype in FWD_EDGE_SHAPES:
        q = (torch.randn(bh, tq, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
        k = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
        dname = str(dtype).replace("torch.", "")
        err_o, err_lse, tol_o = compare(flash, q, k, v, f"{(bh, tq, tk, d)} {dname}")
        plan = flash.plan_flash_fwd(bh, tq, tk, d, dtype)
        print(f"flash_fwd {[bh, tq, tk, d]} {dname} (edge shape): err O {err_o:.3g} (tol {tol_o:.3g}) "
              f"LSE {err_lse:.3g}, repeat bitwise equal; plan {[plan.warpgroups, plan.smem_bytes, plan.splits]}",
              flush=True)
    merges = [merge_row(flash, g, 8, t, 64) for t in (TEXT_TOKENS, LONG_TEXT_TOKENS)]  # the refiner's rows
    return rows, merges


def _attention_inputs(g, bh, tq, tk, d, dtype):
    """q (pre-scaled: unit-variance logits), k, v and dO ~ N(0, 1) in `dtype`."""
    q = (torch.randn(bh, tq, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
    k = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(bh, tq, d, generator=g, device="cuda").to(dtype)
    return q, k, v, do


def compare_bwd(flash, q, k, v, o, lse, do, label: str) -> dict:
    """Max abs error of dQ, dK, dV from the kernels against the plain version
    on the same inputs; fails past BWD_REL_TOL of each gradient's max |plain|,
    and unless a second call gives bitwise-equal gradients (both kernels sum
    in a fixed order, with no atomics)."""
    got = flash.flash_backward(q, k, v, o, lse, do)
    again = flash.flash_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = flash.flash_backward_plain(q, k, v, o, lse, do)
    out = {}
    for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
        check(bool(torch.isfinite(a).all()), f"flash backward {name} not finite at {label}")
        check(torch.equal(a, a2), f"flash backward {name}: two calls differ at {label}")
        err = (a.float() - b.float()).abs().max().item()
        tol = BWD_REL_TOL[q.dtype] * b.float().abs().max().item()
        check(err <= tol, f"flash backward {name} disagrees at {label}: {err} (tol {tol})")
        out[f"err_{name}"], out[f"tol_{name}"] = err, tol
    return out


def bwd_phase(flash) -> list:
    """The backward kernels at the training shapes: error, a bitwise repeat,
    times, bounds, and the launch plan taken (CROSS_SHAPES with Tq != Tk
    among them).

    Per shape: `dq_ms` (the dq kernel, which also computes delta) and
    `dkv_ms` are each kernel's wrapper alone (in fp32 with its split reduce,
    timed alone as `dq_reduce_ms` / `dkv_reduce_ms` on a workspace of the
    plan's splits), `ms` the whole backward as `flash_backward` runs it, all
    graph-timed, each beside its eager time; `library_ms` is the backward
    of `F.scaled_dot_product_attention` on the same inputs, timed as its
    forward + backward in one captured graph less its forward alone (the port
    never calls it).  Bounds, each the largest of three times: the products
    on the tensor cores (`tensor_bound_ms`; the whole backward 5 of
    2*BH*Tq*Tk*D flops: S, dP, dV, dK, dQ; dkv alone S, dP, dV, dK; dq alone
    S, dP, dQ), the BH*Tq*Tk exponentials at EX2_PER_CLK per clock of the card's
    maximum SM clock (`exp_bound_ms`; once for the whole backward, once in
    each kernel), and the bytes: the whole backward reads q, k, v, O, dO and
    LSE and writes dQ, dK, dV; dq reads q, k, v, O, dO, LSE and writes dQ and
    delta; dkv reads q, k, v, dO, LSE, delta and writes dK, dV.  fp32 has
    no tensor cores: its products bound on the FMA pipes (`PEAK_FLOPS`).
    Then checked, not timed, at edge shapes: ragged T, Tq != Tk, D padded,
    and fp32 splits that leave a ragged streamed tile or give some blocks
    fewer tiles than others."""
    import torch.nn.functional as F

    ex2_per_s = EX2_PER_CLK * max_sm_clock_hz()
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rows = []
    for (bh, t, tk, d), dtype, where in _full_shapes(BWD_SHAPES):
        q, k, v, do = _attention_inputs(g, bh, t, tk, d, dtype)
        o, lse = flash.flash_forward(q, k, v)
        dname = str(dtype).replace("torch.", "")
        errs = compare_bwd(flash, q, k, v, o, lse, do, f"{(bh, t, tk, d)} {dname}")
        plan = flash.plan_flash_bwd(bh, t, tk, d, dtype)
        _, delta = flash.flash_bwd_dq(q, k, v, o, do, lse)
        ms, eager_ms = time_ms(lambda: flash.flash_backward(q, k, v, o, lse, do), 20)
        dq_ms, dq_eager = time_ms(lambda: flash.flash_bwd_dq(q, k, v, o, do, lse), 20)
        dkv_ms, dkv_eager = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta), 20)
        reduce_ms, reduce_row = {}, None
        for part, kp, shape in (("dq", plan.dq, q.shape), ("dkv", plan.dkv, (2, *k.shape))):
            if kp.splits > 1:
                ws = torch.randn((kp.splits, *shape), generator=g, device="cuda")
                out = torch.empty(shape, device="cuda")
                reduce_ms[part] = time_ms(lambda: flash.flash_bwd_reduce(ws, out), 20)
                if part == "dkv":  # the reduce against its plain version and torch.sum, on the same partials
                    want = flash.flash_bwd_reduce_plain(ws)
                    flash.flash_bwd_reduce(ws, out)
                    again = flash.flash_bwd_reduce(ws, torch.empty_like(out))
                    torch.cuda.synchronize()
                    check(torch.equal(out, again), f"flash_bwd_reduce: two calls differ at {(bh, t, tk, d)}")
                    reduce_row = {"max_abs_err": (out - want).abs().max().item(), "ms": reduce_ms[part][0],
                                  "eager_ms": reduce_ms[part][1], "splits": kp.splits,
                                  "plain_ms": time_ms(lambda: flash.flash_bwd_reduce_plain(ws), 20)[0],
                                  "library_ms": time_ms(lambda: torch.sum(ws, dim=0), 20)[0],
                                  # the bytes that must cross HBM: the sum written once; the workspace,
                                  # written by dkv just before, is read from L2
                                  "bound_ms": out.numel() * 4 / PEAK_BYTES * 1e3,
                                  "all_bytes_hbm_ms": (kp.splits + 1) * out.numel() * 4 / PEAK_BYTES * 1e3,
                                  "bound_by": "bytes"}
                del ws, out
        plain_ms, _ = time_ms(lambda: flash.flash_backward_plain(q, k, v, o, lse, do), 5)
        q4, k4, v4, do4 = (x[None].detach().requires_grad_() for x in (q, k, v, do))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
            return torch.autograd.grad(out, (q4, k4, v4), do4)

        lib_fwd_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), 20)
        lib_both_ms, _ = time_ms(sdpa_fwd_bwd, 20)
        es, flops_unit, rowbytes = q.element_size(), 2.0 * bh * t * tk * d, bh * t * 4
        io_q, io_k = bh * t * d * es, bh * tk * d * es  # one q-side (q, O, dO, dQ) or k-side tensor
        exp_ms = bh * t * tk / ex2_per_s * 1e3

        def bound(n_products, nbytes):
            t_ms, b_ms = n_products * flops_unit / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
            return {"bound_ms": max(t_ms, exp_ms, b_ms), "tensor_bound_ms": t_ms, "exp_bound_ms": exp_ms,
                    "bound_by": "bytes" if b_ms > max(t_ms, exp_ms) else "operations",
                    "limit": "bytes" if b_ms > max(t_ms, exp_ms) else ("ex2" if exp_ms > t_ms else "tensor")}

        whole = bound(5, 4 * io_q + 4 * io_k + rowbytes)
        dkv_b, dq_b = bound(4, 2 * io_q + 4 * io_k + 2 * rowbytes), bound(3, 4 * io_q + 2 * io_k + 2 * rowbytes)
        row = {"shape": [bh, t, tk, d], "dtype": dname, "where": where, **errs,
               "ms": ms, "eager_ms": eager_ms, "dkv_ms": dkv_ms, "dq_ms": dq_ms, "dkv_eager_ms": dkv_eager,
               "dq_eager_ms": dq_eager, "plain_ms": plain_ms,
               **{f"{part}_reduce_ms": r[0] for part, r in reduce_ms.items()},
               **{f"{part}_reduce_eager_ms": r[1] for part, r in reduce_ms.items()},
               "library_ms": lib_both_ms - lib_fwd_ms, "library_fwd_bwd_ms": lib_both_ms, **whole,
               **{f"dkv_{key}": val for key, val in dkv_b.items()}, **{f"dq_{key}": val for key, val in dq_b.items()},
               "plan": {"dkv": [plan.dkv.warpgroups, plan.dkv.smem_bytes, plan.dkv.splits, plan.dkv.grid],
                        "dq": [plan.dq.warpgroups, plan.dq.smem_bytes, plan.dq.splits, plan.dq.grid]},
               "reduce": reduce_row}
        reduce_text = "".join(f", {part} split reduce {r[0]:.4f} (eager {r[1]:.4f})" for part, r in reduce_ms.items())
        if reduce_row:
            reduce_text += (f" (dkv reduce bound {reduce_row['bound_ms']:.4f}: the sum written at HBM's rate; "
                            f"{reduce_row['all_bytes_hbm_ms']:.4f} with the workspace read from HBM too)")
        print(f"flash_bwd {row['shape']} {dname} ({where}): err dQ {errs['err_dq']:.3g} "
              f"(tol {errs['tol_dq']:.3g}) dK {errs['err_dk']:.3g} (tol {errs['tol_dk']:.3g}) "
              f"dV {errs['err_dv']:.3g} (tol {errs['tol_dv']:.3g}), repeat bitwise equal; graph-timed backward "
              f"{ms:.4f} ms (eager {eager_ms:.4f}) = dq {dq_ms:.4f} (with delta; eager {dq_eager:.4f}) + dkv "
              f"{dkv_ms:.4f} (eager {dkv_eager:.4f}){reduce_text}; {100 * dq_b['tensor_bound_ms'] / dq_ms:.1f}% / "
              f"{100 * dkv_b['tensor_bound_ms'] / dkv_ms:.1f}% of dq / dkv product bound; plain "
              f"{plain_ms:.4f} ms; sdpa backward {row['library_ms']:.4f} ms (fwd+bwd {lib_both_ms:.4f}); "
              f"bound {whole['bound_ms']:.4f} ms ({whole['limit']}; tensor {whole['tensor_bound_ms']:.4f}, ex2 "
              f"{exp_ms:.4f}), {100 * whole['bound_ms'] / ms:.1f}% of bound; dkv bound {dkv_b['bound_ms']:.4f} "
              f"({dkv_b['limit']}, tensor {dkv_b['tensor_bound_ms']:.4f}), dq bound {dq_b['bound_ms']:.4f} "
              f"({dq_b['limit']}, tensor {dq_b['tensor_bound_ms']:.4f}); plan (warpgroups, smem bytes, splits, "
              f"blocks) dkv {row['plan']['dkv']} dq {row['plan']['dq']}", flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, delta, q4, k4, v4, do4
        torch.cuda.empty_cache()
    # correctness only: the forward's edge shapes (ragged T, Tq != Tk, D padded), fp32 split edges
    for (bh, tq, tk, d), dtype in [((3, 100, 77, 40), torch.bfloat16), ((2, 130, 200, 256), torch.bfloat16),
                                   ((2, 1088, 1088, 16), torch.bfloat16), ((1, 64, 64, 128), torch.bfloat16),
                                   ((3, 100, 77, 40), torch.float32), ((2, 130, 70, 256), torch.float32),
                                   ((1, 7, 3, 5), torch.float32), ((2, 600, 600, 64), torch.float32),
                                   ((2, 300, 200, 64), torch.bfloat16), ((3, 1000, 77, 40), torch.float32),
                                   ((2, 77, 1000, 64), torch.float32), ((1, 65, 4097, 16), torch.float32)]:
        q, k, v, do = _attention_inputs(g, bh, tq, tk, d, dtype)
        o, lse = flash.flash_forward(q, k, v)
        dname = str(dtype).replace("torch.", "")
        errs = compare_bwd(flash, q, k, v, o, lse, do, f"{(bh, tq, tk, d)} {dname}")
        plan = flash.plan_flash_bwd(bh, tq, tk, d, dtype)
        print(f"flash_bwd {[bh, tq, tk, d]} {dname} (edge shape): " +
              " ".join(f"{n} {errs['err_' + n]:.3g} (tol {errs['tol_' + n]:.3g})" for n in ("dq", "dk", "dv")) +
              f", repeat bitwise equal; splits dkv {plan.dkv.splits} dq {plan.dq.splits}", flush=True)

    return rows


# conv kernel (csrc/conv3d.cu) limits against its plain version: output max abs
# error within this fraction of max |plain output|.  bf16: one bf16 rounding of
# the output (2^-9 to 2^-8 of a value) plus fp32 summation in another order;
# both versions round the prologue's t to bf16 the same way, so its
# contribution is the rare t whose fp32 value lands on the other side of a
# rounding tie.  fp32: summation order only.  Stats [sum, sumsq]: fp32 sums
# of up to 10^6 voxels in another order, within 1e-4 of max |stats|.
CONV_REL_TOL = {torch.bfloat16: 2**-7, torch.float32: 1e-4}
CONV_STATS_TOL = 1e-4
CONV_SHAPES = [  # (x shape, Cout, options, dtype, where the main paths run it)
    ((1, 64, 128, 128, 64), 64, "affine bias stats", torch.bfloat16, "L0 conv1, mode A"),
    ((1, 64, 128, 128, 64), 64, "affine bias residual", torch.bfloat16, "L0 conv2, mode A"),
    ((1, 64, 128, 128, 192), 64, "affine bias stats", torch.bfloat16, "L0 up_0_0 conv1, mode A"),
    ((1, 64, 128, 128, 64), 64, "bias stats", torch.bfloat16, "L0 conv1, mode 'xla'"),
    ((1, 32, 64, 64, 128), 128, "", torch.bfloat16, "L1 conv3d_3x3_v2, the pallas_conv site"),
    ((1, 32, 64, 64, 128), 128, "activate", torch.bfloat16, "L1 conv3d_3x3 with its SiLU epilogue"),
    ((1, 4, 8, 8, 640), 320, "affine bias stats", torch.bfloat16, "L4 up_4_0 conv1, mode A"),
    ((1, 32, 64, 64, 128), 128, "affine bias stats", torch.float32, "L1 fp32, mode A (fused path in fp32)"),
    ((1, 64, 128, 128, 64), 64, "affine bias stats", torch.float32, "L0 conv1 fp32, mode A (fused path in fp32)"),
    ((1, 4, 8, 8, 640), 320, "affine bias stats", torch.float32, "L4 up_4_0 conv1 fp32, mode A, split-K"),
    ((1, 32, 64, 64, 128), 128, "activate", torch.float32, "L1 conv3d_3x3 fp32 with its SiLU epilogue"),
    ((1, 32, 64, 64, 128), 128, "affine bias stats", torch.bfloat16, "L1 conv1, mode A"),
    ((1, 16, 32, 32, 384), 128, "affine bias stats", torch.bfloat16, "L2 up_2_0 conv1, mode A"),
    ((1, 8, 16, 16, 576), 256, "affine bias stats", torch.bfloat16, "L3 up_3_0 conv1, mode A"),
]
CONV_EDGE_SHAPES = [  # checked, not timed: W not a tile multiple, batch 2, Cin 4, ragged Cout, no split
    ((1, 3, 8, 10, 8), 12, "affine bias stats"),
    ((2, 3, 8, 8, 16), 16, "activate"),
    ((1, 2, 8, 8, 4), 8, "affine bias residual"),
    ((1, 5, 16, 24, 40), 72, "bias residual stats"),
    ((2, 9, 36, 40, 24), 72, "affine bias stats"),
]
CONV_FLAGS = {"affine": 1, "bias": 2, "residual": 4, "stats": 8, "activate": 16}  # csrc/conv3d.cu's


def conv_flags(opts: str) -> int:
    return sum(CONV_FLAGS[o] for o in opts.split())


def resblock_channels(unet_cfg: dict) -> list:
    """(level, in_ch, out_ch) of each ResBlock of the stage-1 UNet in forward
    order, by nn/unet.py's channel bookkeeping (mid blocks at the last level)."""
    mc, mult, nrb = unet_cfg["base_channels"], unet_cfg["channel_mult"], unet_cfg.get("num_res_blocks", 2)
    ch, skip, blocks = mc * mult[0], [mc * mult[0]], []
    for level, m in enumerate(mult):
        for _ in range(nrb):
            blocks.append((level, ch, m * mc))
            ch = m * mc
            skip.append(ch)
        if level != len(mult) - 1:
            skip.append(ch)
    blocks += [(len(mult) - 1, ch, ch)] * 2
    for level, m in reversed(list(enumerate(mult))):
        for _ in range(nrb + 1):
            blocks.append((level, ch + skip.pop(), m * mc))
            ch = m * mc
    return blocks


def fused_conv_calls(unet_cfg: dict, spatial, mode: str) -> list:
    """(x shape, Cout, options) of each conv kernel call of one fused UNet
    forward ('kernel': mode A, the prologue in the kernel; 'xla': mode B)."""
    pro = "affine " if mode == "kernel" else ""
    calls = []
    for level, cin, cout in resblock_channels(unet_cfg):
        sp = tuple(s // 2 ** level for s in spatial)
        calls.append(((1, *sp, cin), cout, pro + "bias stats"))
        calls.append(((1, *sp, cout), cout, pro + "bias residual"))
    return calls


def planned_launches(conv, calls, dtype=torch.bfloat16) -> dict:
    """Kernel launches of conv calls in `dtype`, by counter, from the launch planner."""
    total = {"conv3d": 0, "conv3d_splitk_reduce": 0, "conv3d_stats_reduce": 0}
    for shape, cout, opts in calls:
        for k, v in conv.plan_conv3d(*shape, cout, dtype, conv_flags(opts)).launches.items():
            total[k] += v
    return total


def plan_text(conv, shape, cout, opts, dtype) -> str:
    p = conv.plan_conv3d(*shape, cout, dtype, conv_flags(opts))
    return f"plan tile {'x'.join(map(str, p.tile))} bn {p.bn} splits {p.splits} grid {list(p.grid)}"


def _conv_inputs(g, shape, cout, opts, dtype):
    cin = shape[-1]
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = torch.randn((3, 3, 3, cin, cout), generator=g, device="cuda") / math.sqrt(27 * cin)
    kw = {"want_stats": "stats" in opts, "activate": "activate" in opts}
    if "affine" in opts:
        kw["scale"] = torch.rand(cin, generator=g, device="cuda") + 0.5
        kw["shift"] = torch.randn(cin, generator=g, device="cuda") * 0.5
    if "bias" in opts:
        kw["bias"] = torch.randn(cout, generator=g, device="cuda") * 0.1
    if "residual" in opts:
        kw["residual"] = torch.randn((*shape[:4], cout), generator=g, device="cuda").to(dtype)
    return x, k, kw


def compare_conv(conv, x, k, kw, label: str) -> dict:
    """Max abs error of the kernel (output, stats) against its plain version
    on the same inputs; fails past CONV_REL_TOL / CONV_STATS_TOL, and unless
    a second call gives a bitwise-equal output (and stats): the kernel sums
    in a fixed order, with no atomics."""
    got = conv.conv3d_igemm(x, k, **kw)
    again = conv.conv3d_igemm(x, k, **kw)
    torch.cuda.synchronize()
    want = conv.conv3d_plain(x, k, **kw)
    got, again, want = (got, again, want) if kw["want_stats"] else ((got, None), (again, None), (want, None))
    check(bool(torch.isfinite(got[0]).all()), f"conv3d output not finite at {label}")
    check(torch.equal(got[0], again[0]) and (got[1] is None or torch.equal(got[1], again[1])),
          f"conv3d: two calls differ at {label}")
    err = (got[0].float() - want[0].float()).abs().max().item()
    tol = CONV_REL_TOL[x.dtype] * want[0].float().abs().max().item()
    out = {"err": err, "tol": tol, "err_stats": None, "tol_stats": None}
    if kw["want_stats"]:
        out["err_stats"] = (got[1] - want[1]).abs().max().item()
        out["tol_stats"] = CONV_STATS_TOL * want[1].abs().max().item()
    check(err <= tol and (out["err_stats"] or 0.0) <= (out["tol_stats"] or 0.0),
          f"conv3d disagrees at {label}: output {err} (tol {tol}), stats {out['err_stats']} "
          f"(tol {out['tol_stats']})")
    return out


def _err_text(errs: dict) -> str:
    return f"err {errs['err']:.3g} (tol {errs['tol']:.3g})" + (
        f", stats {errs['err_stats']:.3g} (tol {errs['tol_stats']:.3g})" if errs["err_stats"] is not None else "")


def conv_phase(conv) -> tuple:
    """The conv kernel at the fused and pallas_conv paths' shapes: error, a
    bitwise repeat, times (graph-timed kernel, eager, plain, F.conv3d on the
    channels_last_3d view as the library call), bound, and the plan each
    shape took.  Then checked, not timed: every distinct conv of the fused
    'kernel' path and the edge shapes, in bf16 and fp32.  Bound:
    2*V*27*Cin*Cout flops; bytes x, the weight, the output and the residual
    once each."""
    import torch.nn.functional as F
    from jointimagegeneration_torch.core.runtime import configure_precision

    configure_precision()  # the fp32 plain version runs in full fp32
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    rows = []
    for shape, cout, opts, dtype, where in CONV_SHAPES:
        x, k, kw = _conv_inputs(g, shape, cout, opts, dtype)
        dname = str(dtype).replace("torch.", "")
        label = f"{list(shape)}->{cout} [{opts}] {dname}"
        errs = compare_conv(conv, x, k, kw, label)
        ms, eager_ms = time_ms(lambda: conv.conv3d_igemm(x, k, **kw), 20)
        plain_ms, _ = time_ms(lambda: conv.conv3d_plain(x, k, **kw), 3)
        xl, wl = x.movedim(-1, 1), k.to(dtype).permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        library_ms, _ = time_ms(lambda: F.conv3d(xl, wl, padding=1), 20)
        es = x.element_size()
        flops = conv.conv_flops(shape, cout)
        nbytes = (x.numel() + 27 * shape[-1] * cout + math.prod(shape[:4]) * cout
                  * (2 if "residual" in opts else 1)) * es
        f_ms, b_ms = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        plan = plan_text(conv, shape, cout, opts, dtype)
        row = {"shape": list(shape), "cout": cout, "options": opts, "dtype": dname, "where": where, **errs,
               "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(f_ms, b_ms), "bound_by": "operations" if f_ms >= b_ms else "bytes",
               "tflops": flops / ms / 1e9, "plan": plan}
        print(f"conv3d {label} ({where}): {_err_text(errs)}, repeat bitwise equal; graph-timed kernel "
              f"{ms:.4f} ms (eager {eager_ms:.4f}, {row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"F.conv3d {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{100 * row['bound_ms'] / ms:.1f}% of bound; {plan}", flush=True)
        rows.append(row)
        del x, k, kw, xl, wl
        torch.cuda.empty_cache()
    edge = []
    spatial = TWO_STAGE_CFG["stage1"]["dataset"]["volume_shape"]
    fused = sorted(set(fused_conv_calls(TWO_STAGE_CFG["stage1"]["unet_openai"], spatial, "kernel")),
                   key=lambda c: (-c[0][1], c[0][-1], c[1], c[2]))
    checks = [(shape, cout, opts, dtype, "fused path") for dtype in (torch.bfloat16, torch.float32)
              for shape, cout, opts in fused]
    checks += [(shape, cout, opts, dtype, "edge shape") for shape, cout, opts in CONV_EDGE_SHAPES
               for dtype in (torch.bfloat16, torch.float32)]
    for shape, cout, opts, dtype, kind in checks:
        x, k, kw = _conv_inputs(g, shape, cout, opts, dtype)
        dname = str(dtype).replace("torch.", "")
        errs = compare_conv(conv, x, k, kw, f"{list(shape)}->{cout} [{opts}] {dname}")
        edge.append({"shape": list(shape), "cout": cout, "options": opts, "dtype": dname, "kind": kind, **errs})
        print(f"conv3d {list(shape)}->{cout} [{opts}] {dname} ({kind}): {_err_text(errs)}, repeat bitwise "
              f"equal; {plan_text(conv, shape, cout, opts, dtype)}", flush=True)
        del x, k, kw
    torch.cuda.empty_cache()
    return rows, edge


class _CpuDrawnNoise:
    """Draws on the CPU from one seed and hands them to `device`, so a run on
    the card and a run on the CPU see the same numbers."""

    def __init__(self, seed: int, device: str):
        from jointimagegeneration_torch.diffusion.noise import NoiseSource

        self.src, self.device = NoiseSource(seed, "cpu"), device

    def normal(self, shape):
        return self.src.normal(shape).to(self.device)

    def uniform(self, shape):
        return self.src.uniform(shape).to(self.device)

    def gumbel(self, shape):
        return self.src.gumbel(shape).to(self.device)

    def randint(self, low, high, shape):
        return self.src.randint(low, high, shape).to(self.device)


def reference_phase(flash) -> float:
    """A tiny fp32 two-stage pipeline (attention sites at T >= 512, so the card
    runs the kernel) on the card against the CPU; returns the CT max error."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler, build_slice_ldm
    from jointimagegeneration_torch.diffusion.ddim import DDIMParams
    from jointimagegeneration_torch.pipeline.two_stage import TwoStagePipeline

    s1 = {"num_classes": 4, "time_steps": 20, "bf16": False,
          "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [1],
                          "num_head_channels": 4}}
    s2 = {"timesteps": 100, "bf16": False,
          "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2],
                                     "attention_resolutions": [1], "num_head_channels": 4}}}
    runs = []  # (ct, labels, kernel launches) on the CPU, then on the card
    cpu_state = None
    for device in ("cpu", "cuda"):
        ms, ldm = build_mask_sampler(s1, device), build_slice_ldm(s2, device)
        if cpu_state is None:
            gen = torch.Generator().manual_seed(7)
            with torch.no_grad():
                for p in list(ms.unet.parameters()) + list(ldm.unet.parameters()):
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))  # un-zero every kernel
            cpu_state = (ms.unet.state_dict(), ldm.unet.state_dict())
        else:
            ms.unet.load_state_dict(cpu_state[0])
            ldm.unet.load_state_dict(cpu_state[1])
        ddim = DDIMParams.create(ldm.diffusion, 4)
        cond = torch.zeros((1, 8, 8, 8, 1), device=device)
        before = flash.flash_forward.launches
        with torch.inference_mode():
            ct, labels = TwoStagePipeline(ms, ldm)(_CpuDrawnNoise(3, device), mask_shape=(1, 8, 8, 8),
                                                   volume_shape=(3, 32, 32), ddim=ddim, mask_steps=3,
                                                   cond=cond)
        runs.append((ct.cpu().numpy(), labels.cpu().numpy(), flash.flash_forward.launches - before))
    (ct_cpu, lab_cpu, n_cpu), (ct_gpu, lab_gpu, n_gpu) = runs
    check(n_gpu > 0 and n_cpu == 0, f"reference phase: kernel launches cpu {n_cpu}, card {n_gpu}")
    agree = float(np.mean(lab_gpu == lab_cpu))
    err = float(np.abs(ct_gpu - ct_cpu).max())
    print(f"reference: tiny fp32 pipeline, card vs CPU: labels agree on {100 * agree:.2f}% of voxels, "
          f"CT max abs diff {err:.3g} ({n_gpu} kernel launches on the card)", flush=True)
    check(agree >= 0.999 and err <= 1e-3, "reference phase: card and CPU pipelines disagree")
    return err


SAMPLER_REF_TOL = 1e-3  # card vs CPU, fp32, max abs: the reference phase's limit


def sampler_reference_phase(flash) -> dict:
    """The stage-2 sampler routes on a tiny fp32 SliceLDM (LDM_REF_UNET at
    32x32 slices: T = 1024 at its 4 attention sites, so the card runs the
    kernel) on the card against the CPU, same weights, same draws: DPM and
    PLMS volumes with and without warm start 0.5, DDIM with guidance 2.0,
    inpaint and outpaint, a 48x48 slice tiled in 32x32 windows, and at T = 20
    p_sample_loop, progressive_denoising and log_images.  Each within
    SAMPLER_REF_TOL, its launches 4 x its UNet calls on the card and 0 on the
    CPU; then stream_volume equals sample_volume bit for bit on the card.
    Returns the launches and errors by route."""
    from jointimagegeneration_torch.cli.sample import build_slice_ldm
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.diffusion.ddim import DDIMParams

    configure_precision()
    gen = torch.Generator().manual_seed(8)
    mask = (torch.randint(0, 12, (1, 3, 32, 32, 1), generator=gen) / 11.0)
    wide = (torch.randint(0, 12, (1, 1, 48, 48, 1), generator=gen) / 11.0)
    image, prev = torch.rand((2, 32, 32, 1), generator=gen), torch.rand((2, 32, 32, 1), generator=gen)
    cond = torch.cat([prev, mask[0, :2]], dim=-1)
    keep = torch.zeros((2, 32, 32, 1))
    keep[:, :, :16] = 1.0
    routes = {  # route -> (model, fn(SliceLDM, noise, DDIMParams, to_device) -> one tensor of its outputs)
        "dpm": ("t100", lambda m, n, d, c: m.sample_volume(n, c(mask), d, sampler="dpm")),
        "dpm warm 0.5": ("t100", lambda m, n, d, c: m.sample_volume(n, c(mask), d, sampler="dpm", warm_start=0.5)),
        "plms": ("t100", lambda m, n, d, c: m.sample_volume(n, c(mask), d, sampler="plms")),
        "plms warm 0.5": ("t100", lambda m, n, d, c: m.sample_volume(n, c(mask), d, sampler="plms",
                                                                      warm_start=0.5)),
        "ddim guidance 2.0": ("t100", lambda m, n, d, c: m.sample_volume(n, c(mask), d, guidance_scale=2.0)),
        "inpaint": ("t100", lambda m, n, d, c: m.sample_slice(n, c(cond), d, inpaint_mask=c(keep),
                                                              inpaint_x0=c(image))),
        "outpaint": ("t100", lambda m, n, d, c: m.sample_slice(n, c(cond), d, inpaint_mask=c(1.0 - keep),
                                                               inpaint_x0=c(image))),
        "tile 32/16 on 48x48": ("t100", lambda m, n, d, c: m.sample_volume(n, c(wide), d, tile=((32, 32), (16, 16)))),
        "p_sample_loop": ("t20", lambda m, n, d, c: torch.cat([r.flatten() for r in m.p_sample_loop(
            n, c(cond), return_intermediates=True)])),
        "progressive_denoising": ("t20", lambda m, n, d, c: torch.cat(
            [r.flatten() for r in m.progressive_denoising(n, c(cond))])),
        "log_images": ("t20", lambda m, n, d, c: torch.cat([torch.from_numpy(v).flatten() for v in m.log_images(
            n, {"image": c(image), "cond": c(cond)}, d, progressive=True).values()])),
    }
    models, init = {}, {}
    for device in ("cpu", "cuda"):
        for name, timesteps, steps in (("t100", 100, 10), ("t20", 20, 5)):
            ldm = build_slice_ldm({"bf16": False, "timesteps": timesteps, "unet_config": {"params": LDM_REF_UNET}},
                                  device)
            if name not in init:
                with torch.no_grad():
                    for p in ldm.unet.parameters():
                        p.add_(0.02 * torch.randn(p.shape, generator=gen))  # un-zero every kernel
                init[name] = ldm.unet.state_dict()
            else:
                ldm.unet.load_state_dict(init[name])
            models[device, name] = (ldm, DDIMParams.create(ldm.diffusion, steps, method="uniform_lambda"))
    sites = flash_sites([32, 32], LDM_REF_UNET, "channel_mult")
    out = {}
    for route, (name, fn) in routes.items():
        res = []
        for device in ("cpu", "cuda"):
            ldm, ddim = models[device, name]
            calls, flash_calls = [], []
            hooks = [ldm.unet.register_forward_pre_hook(lambda *_: calls.append(1))]
            hooks += _flash_attention_calls((ldm.unet,), flash_calls)
            before, merges = flash.flash_forward.launches, flash.flash_fwd_merge.launches
            with torch.inference_mode():
                y = fn(ldm, _CpuDrawnNoise(4, device), ddim, lambda t: t.to(device))
            for h in hooks:
                h.remove()
            res.append((y.float().cpu(), flash.flash_forward.launches - before, len(calls),
                        flash.flash_fwd_merge.launches - merges, call_merges(flash, flash_calls)))
        (y_cpu, n_cpu, calls_cpu, m_cpu, _), (y_gpu, n_gpu, calls_gpu, m_gpu, m_want) = res
        err = (y_gpu - y_cpu).abs().max().item()
        print(f"sampler reference ({route}): tiny fp32 SliceLDM, card vs CPU max abs diff {err:.3g} "
              f"(tol {SAMPLER_REF_TOL}); {calls_gpu} UNet calls, flash_fwd launches cpu {n_cpu}, card {n_gpu}; "
              f"flash_fwd_merge {m_gpu} (planned {m_want})", flush=True)
        check(bool(torch.isfinite(y_gpu).all()) and y_gpu.shape == y_cpu.shape, f"sampler reference ({route}): output")
        check(calls_cpu == calls_gpu > 0 and n_cpu == m_cpu == 0 and n_gpu == sites * calls_gpu and m_gpu == m_want,
              f"sampler reference ({route}): launches cpu {n_cpu}, card {n_gpu}, merges {m_gpu} (planned "
              f"{m_want}), UNet calls {calls_gpu}")
        check(err <= SAMPLER_REF_TOL, f"sampler reference ({route}): card and CPU disagree by {err}")
        out[route] = {"max_abs_err": err, "launches": n_gpu, "merges": m_gpu}
    ldm, ddim = models["cuda", "t100"]
    kw = {"sampler": "dpm", "warm_start": 0.5, "guidance_scale": 2.0}
    with torch.inference_mode():
        streamed = torch.stack(list(ldm.stream_volume(_CpuDrawnNoise(5, "cuda"), mask.cuda(), ddim, **kw)), dim=1)
        whole = ldm.sample_volume(_CpuDrawnNoise(5, "cuda"), mask.cuda(), ddim, **kw)
    check(torch.equal(streamed, whole), "sampler reference: stream_volume differs from sample_volume on the card")
    print("sampler reference: stream_volume equals sample_volume bit for bit on the card (dpm, warm 0.5, "
          "guidance 2.0)", flush=True)
    return out


def _flash_attention_calls(modules, calls: list) -> list:
    """Forward pre-hooks on every AttentionBlock of `modules` that append the
    flash forward's (BH, T, D) per call whose sequence the flash rule takes
    (T >= FLASH_MIN_SEQ, eligible shape); returns the hook handles."""
    from jointimagegeneration_torch.nn.blocks import AttentionBlock
    from jointimagegeneration_torch.ops.attention import FLASH_MIN_SEQ
    from jointimagegeneration_torch.ops.flash_attention import flash_eligible

    def hook(block, args):
        x = args[0]
        t, d = math.prod(x.shape[1:-1]), x.shape[-1] // block.heads
        if t >= FLASH_MIN_SEQ and flash_eligible(t, t, d):
            calls.append((x.shape[0] * block.heads, t, d))

    return [m.register_forward_pre_hook(hook) for mod in modules for m in mod.modules()
            if isinstance(m, AttentionBlock)]


def latent_reference_phase(flash) -> dict:
    """The latent `_ae` route on a tiny fp32 LatentSliceLDM on the card against
    the CPU, same weights, same draws: KL-VAE first and cond stages
    (LATENT_REF_AE at 64x64, every parameter perturbed, proj_out included)
    around LDM_REF_UNET on the 32x32x4 latent (T = 1024 at its 4 attention
    sites): a DDIM volume, DPM with warm start 0.5, DDIM with guidance 2.0
    and a latent two-stage run in two chunks of 2 slices, each within
    SAMPLER_REF_TOL; its launches on the card 4 x the UNet's calls plus the
    AEs' attention calls at T >= 512 (the tiny AEs' heads are 8 and 16 wide),
    none on the CPU; then stream_volume equals sample_volume bit for bit on
    the card.  Last, an AE at 64x64 whose mid attention holds 1,024 tokens of
    one 288-wide head, beyond the flash rule's 256: encode and decode card
    against CPU within 1e-4 of their max, and no flash launch."""
    from jointimagegeneration_torch.cli.common import build_autoencoder
    from jointimagegeneration_torch.cli.sample import build_mask_sampler, build_slice_ldm
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.diffusion.ddim import DDIMParams
    from jointimagegeneration_torch.models.latent_ldm import LatentSliceLDM
    from jointimagegeneration_torch.pipeline.two_stage import make_chunked_two_stage_programs

    configure_precision()
    gen = torch.Generator().manual_seed(10)
    mask = torch.randint(0, 12, (1, 3, 64, 64, 1), generator=gen) / 11.0
    dd = LATENT_REF_AE["ddconfig"]
    s1 = {"num_classes": 4, "time_steps": 20, "bf16": False,
          "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [1],
                          "num_head_channels": 4}}
    s2 = {"bf16": False, "timesteps": 100, "channels": 4, "cond_channels": 4, "unet_config": {"params": LDM_REF_UNET}}
    models, init = {}, None
    for device in ("cpu", "cuda"):
        ae = build_autoencoder({**LATENT_REF_AE, "ddconfig": {**dd, "in_channels": 1, "out_ch": 1}}, device, 3)
        cae = build_autoencoder({**LATENT_REF_AE, "ddconfig": {**dd, "in_channels": 2, "out_ch": 2}}, device, 5)
        ldm, ms = build_slice_ldm(s2, device), build_mask_sampler(s1, device)
        mods = (ae, cae, ldm.unet, ms.unet)
        if init is None:
            with torch.no_grad():
                for m in mods:
                    for p in m.parameters():
                        p.add_(0.02 * torch.randn(p.shape, generator=gen))  # un-zero every kernel
            init = [m.state_dict() for m in mods]
        else:
            for m, sd in zip(mods, init):
                m.load_state_dict(sd)
        latent = LatentSliceLDM(inner=ldm, first_stage=ae.eval(), cond_stage=cae.eval(), scale_factor=0.7)
        models[device] = (latent, ms, DDIMParams.create(ldm.diffusion, 6, method="uniform_lambda"))

    def two_stage(latent, ms, n, d, c):
        mask_program, chunk_program = make_chunked_two_stage_programs(
            ms, latent, mask_shape=(1, 4, 8, 8), volume_shape=(4, 64, 64), ddim=d, chunk=2, mask_steps=3,
            cond=c(torch.zeros((1, 4, 8, 8, 1))), sampler="dpm", guidance_scale=2.0)
        labels, channel = mask_program(n)
        v0, last = chunk_program(n, channel[:, :2], None)
        v1, _ = chunk_program(n, channel[:, 2:], last)
        return torch.cat([labels.float().flatten(), v0.flatten(), v1.flatten()])

    routes = {  # route -> fn(LatentSliceLDM, MaskSampler, noise, DDIMParams, to_device) -> one tensor
        "ddim": lambda m, s, n, d, c: m.sample_volume(n, c(mask), d),
        "dpm warm 0.5": lambda m, s, n, d, c: m.sample_volume(n, c(mask), d, sampler="dpm", warm_start=0.5),
        "ddim guidance 2.0": lambda m, s, n, d, c: m.sample_volume(n, c(mask), d, guidance_scale=2.0),
        "two_stage chunked (dpm, guidance 2.0)": two_stage,
    }
    sites = flash_sites([32, 32], LDM_REF_UNET, "channel_mult")
    out = {}
    for route, fn in routes.items():
        res = []
        for device in ("cpu", "cuda"):
            latent, ms, ddim = models[device]
            calls, ae_calls, unet_flash = [], [], []
            hooks = [latent.unet.register_forward_pre_hook(lambda *_: calls.append(1))]
            hooks += _flash_attention_calls((latent.first_stage, latent.cond_stage), ae_calls)
            hooks += _flash_attention_calls((latent.unet,), unet_flash)
            before, merges = flash.flash_forward.launches, flash.flash_fwd_merge.launches
            with torch.inference_mode():
                y = fn(latent, ms, _CpuDrawnNoise(4, device), ddim, lambda t: t.to(device))
            for h in hooks:
                h.remove()
            res.append((y.float().cpu(), flash.flash_forward.launches - before, len(calls), len(ae_calls),
                        flash.flash_fwd_merge.launches - merges, call_merges(flash, unet_flash + ae_calls)))
        (y_cpu, n_cpu, calls_cpu, ae_cpu, m_cpu, _), (y_gpu, n_gpu, calls_gpu, ae_gpu, m_gpu, m_want) = res
        err = (y_gpu - y_cpu).abs().max().item()
        expected = sites * calls_gpu + ae_gpu
        print(f"latent reference ({route}): tiny fp32 LatentSliceLDM, card vs CPU max abs diff {err:.3g} "
              f"(tol {SAMPLER_REF_TOL}); {calls_gpu} UNet calls, {ae_gpu} AE attention calls at T >= 512; "
              f"flash_fwd launches cpu {n_cpu}, card {n_gpu} = {sites} x {calls_gpu} + {ae_gpu}; "
              f"flash_fwd_merge {m_gpu} (planned {m_want})", flush=True)
        check(bool(torch.isfinite(y_gpu).all()) and y_gpu.shape == y_cpu.shape, f"latent reference ({route}): output")
        check(calls_cpu == calls_gpu > 0 and ae_cpu == ae_gpu > 0 and n_cpu == m_cpu == 0 and n_gpu == expected
              and m_gpu == m_want,
              f"latent reference ({route}): launches cpu {n_cpu}, card {n_gpu}, merges {m_gpu} (planned "
              f"{m_want}), expected {expected}")
        check(err <= SAMPLER_REF_TOL, f"latent reference ({route}): card and CPU disagree by {err}")
        out[route] = {"max_abs_err": err, "launches": n_gpu, "merges": m_gpu, "unet_calls": calls_gpu,
                      "ae_flash_calls": ae_gpu}
    latent, _, ddim = models["cuda"]
    kw = {"sampler": "dpm", "warm_start": 0.5, "guidance_scale": 2.0}
    with torch.inference_mode():
        streamed = torch.stack(list(latent.stream_volume(_CpuDrawnNoise(5, "cuda"), mask.cuda(), ddim, **kw)), dim=1)
        whole = latent.sample_volume(_CpuDrawnNoise(5, "cuda"), mask.cuda(), ddim, **kw)
    check(torch.equal(streamed, whole), "latent reference: stream_volume differs from sample_volume on the card")
    print("latent reference: stream_volume equals sample_volume bit for bit on the card (dpm, warm 0.5, "
          "guidance 2.0)", flush=True)
    # the plain attention beyond the flash rule: one head of 288 over 1,024 tokens
    wide = {"embed_dim": 4, "ddconfig": {"ch": 144, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4,
                                         "in_channels": 1, "out_ch": 1, "resolution": 64}}
    x = torch.rand((2, 64, 64, 1), generator=gen)
    res, state = [], None
    for device in ("cpu", "cuda"):
        ae = build_autoencoder(wide, device, 3).eval()
        if state is None:
            with torch.no_grad():
                for p in ae.parameters():
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))
            state = ae.state_dict()
        else:
            ae.load_state_dict(state)
        before = flash.flash_forward.launches
        with torch.inference_mode():
            post = ae.encode(x.to(device))
            rec = ae.decode(post.mode())
        res.append((post.mean.cpu(), rec.float().cpu(), flash.flash_forward.launches - before))
    (m_cpu, r_cpu, _), (m_gpu, r_gpu, n_gpu) = res
    errs = [(g - c).abs().max().item() / c.abs().max().item() for g, c in ((m_gpu, m_cpu), (r_gpu, r_cpu))]
    print(f"latent reference (AE, mid attention 1 x 288 over 1024 tokens): card vs CPU encode {errs[0]:.3g}, "
          f"decode {errs[1]:.3g} of their max (tol {TRAIN_REF_TOL}); flash_fwd launches {n_gpu}", flush=True)
    check(n_gpu == 0 and max(errs) <= TRAIN_REF_TOL, f"latent reference (AE): errors {errs}, launches {n_gpu}")
    out["ae_wide_head"] = {"max_rel_err": max(errs), "launches": n_gpu}
    del models, latent
    torch.cuda.empty_cache()
    return out


def flash_sites(spatial, cfg_unet: dict, mult_key: str) -> int:
    """Attention sites of one UNet forward that take the flash kernel (T >= 512)."""
    from jointimagegeneration_torch.ops.attention import FLASH_MIN_SEQ

    mult = cfg_unet[mult_key]
    nrb = cfg_unet.get("num_res_blocks", 2)
    n = 0
    for level in range(len(mult)):
        ds = 2 ** level
        if ds in cfg_unet["attention_resolutions"] and math.prod(s // ds for s in spatial) >= FLASH_MIN_SEQ:
            n += nrb + (nrb + 1)  # encoder blocks + decoder blocks at this level
    mid_ds = 2 ** (len(mult) - 1)
    return n + (math.prod(s // mid_ds for s in spatial) >= FLASH_MIN_SEQ)


def stage2_calls(cfg: dict) -> int:
    """UNet calls of `cli.sample.run`'s stage 2 under `cfg`: per slice S nodes
    (DDIM, DPM) or S + 1 (PLMS's Heun step); under warm_start f a slice after
    each chunk's first runs k = max(1, min(S, round(f * S))) nodes
    (SliceLDM.warm_start_index); guidance (a scale other than 1) doubles
    every call."""
    s = cfg["ddim_steps"]
    plms = cfg.get("sampler", "ddim") == "plms"
    f = cfg.get("warm_start")
    k = s if f is None else max(1, min(s, int(round(f * s))))
    n_chunks = cfg["slices"] // cfg.get("chunk", cfg["slices"])
    per_chunk = (s + plms) + (cfg.get("chunk", cfg["slices"]) - 1) * (k + plms)
    return n_chunks * per_chunk * (2 if float(cfg.get("guidance_scale", 1.0)) != 1.0 else 1)


def stage1_launches(s1: dict, steps: int, ctx_len: int = 0) -> int:
    """flash_fwd launches of one stage-1 chain of `steps` UNet calls: one per
    flash site a call, two (attn1 and attn2) with a `selfattn` encoder, whose
    refiner adds two per block (once a chain) when its `ctx_len`-token
    context takes the flash rule."""
    from jointimagegeneration_torch.ops.attention import FLASH_MIN_SEQ
    from jointimagegeneration_torch.ops.flash_attention import flash_eligible

    fce = s1.get("feature_cond_encoder") or {}
    text = fce.get("type") == "selfattn"
    per_call = flash_sites(s1["dataset"]["volume_shape"], s1["unet_openai"], "channel_mult") * (2 if text else 1)
    d_head = fce.get("d_head", 64)
    refine = (text and fce.get("train", True) and ctx_len >= FLASH_MIN_SEQ
              and flash_eligible(ctx_len, ctx_len, d_head))
    return steps * per_call + (2 * fce.get("model_depth", 4) if refine else 0)


def sampling_run(flash, cfg: dict, label: str, card: str, ctx_len: int = 0) -> dict:
    """`cli.sample.run(cfg)` on the card with the launch counts zeroed before
    it; checks the outputs, the files and that flash_fwd (and no other
    kernel) launched `stage1_launches` (mask_steps x stage-1 sites, with a
    text context of `ctx_len` tokens attn1 + attn2 and the refiner) +
    stage2_calls x stage-2 sites times.  Returns the launches and stage-2
    s/slice."""
    from jointimagegeneration_torch.cli.sample import run

    s1, s2 = cfg["stage1"], cfg["stage2"]
    u2 = s2["unet_config"]["params"]
    expected = (stage1_launches(s1, cfg["mask_steps"], ctx_len)
                + stage2_calls(cfg) * flash_sites([s2["slice_size"]] * 2, u2, "channel_mult"))
    _reset_counts(flash)
    t0 = time.perf_counter()
    result = run(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches, merges = flash.flash_forward.launches, flash.flash_fwd_merge.launches
    others = {k: v for k, v in _counts(flash).items() if k not in ("flash_fwd", "flash_fwd_merge")}
    check(not any(others.values()), f"{label}: sampling launched other kernels: {others}")
    want_merges = stage1_merges(flash, s1, ctx_len)
    check(merges == want_merges, f"{label}: flash_fwd_merge launched {merges} times, expected {want_merges}")
    ct, labels = result["ct"], result["labels"]
    check(ct.shape == (1, cfg["slices"], *cfg["volume_shape"][1:]), f"{label}: CT shape {ct.shape}")
    check(labels.shape == (1, *cfg["volume_shape"]), f"{label}: label shape {labels.shape}")
    check(bool(np.isfinite(ct).all()), f"{label}: CT has non-finite values")
    check(float(ct.min()) >= 0.0 and float(ct.max()) <= 1.0, f"{label}: CT outside [0, 1]: {ct.min()} {ct.max()}")
    check(int(labels.min()) >= 0 and int(labels.max()) < s1["num_classes"], f"{label}: labels outside [0, 12)")
    for name in ("image.nii.gz", "pred.nii.gz"):
        check((Path(cfg["output_path"]) / "case_0000" / name).stat().st_size > 352, f"{label}: {name} not written")
    check(launches == expected, f"{label}: flash_fwd launched {launches} times, expected {expected}")
    sec = result["seconds"]
    route = ", ".join(f"{k} {cfg[k]}" for k in ("ddim_discretize", "warm_start", "guidance_scale") if k in cfg)
    s_slice = sec["stage2"] / cfg["slices"]
    print(f"{label}: stage 1 ({cfg['mask_steps']} steps at 64x128x128, base 64, bf16) {sec['stage1']:.3f} s, "
          f"{sec['stage1'] / cfg['mask_steps']:.4f} s/step; stage 2 ({cfg['slices']} slices x "
          f"{cfg['ddim_steps']} {cfg.get('sampler', 'ddim')} nodes{', ' + route if route else ''}, at 256x256, "
          f"base 128, bf16; {stage2_calls(cfg)} UNet calls) {sec['stage2']:.3f} s, {s_slice:.4f} s/slice, "
          f"{sec['stage2'] / stage2_calls(cfg):.4f} s/call; run() wall {wall:.3f} s (incl. model init and NIfTI "
          f"writes); flash_fwd launches {launches} = expected {expected}; classes present "
          f"{np.unique(labels).size}; card {card}", flush=True)
    return {"launches": launches, "merges": merges, "s_per_slice": s_slice, "stage2_s": sec["stage2"],
            "stage1_s": sec["stage1"], "stage2_calls": stage2_calls(cfg)}


def path_phase(flash, card: str) -> dict:
    cfg = json.loads(json.dumps(TWO_STAGE_CFG))
    cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / "samples")
    return sampling_run(flash, cfg, "path", card)


def fast_path_phase(flash, card: str, ddim_path: dict) -> dict:
    """`cli.sample.run` on `configs/sample_two_stage.yml` again (the path
    phase's run, now with the stage-2 UNet warm), on
    `configs/sample_two_stage_fast.yml` (FAST_CFG), then on its variant (PLMS,
    warm start 0.4, guidance 2.0): stage-2 s/slice of DPM-20 beside DDIM-50's,
    warm and as the path phase read it."""
    out = {}
    for name, base, extra in (("ddim path, warm", TWO_STAGE_CFG, {}), ("fast path", FAST_CFG, {}),
                              ("fast path variant", FAST_CFG, FAST_VARIANT)):
        cfg = json.loads(json.dumps({**base, **extra}))
        cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / name.replace(" ", "_").replace(",", ""))
        out[name] = sampling_run(flash, cfg, name, card)
    fast, warm = out["fast path"]["s_per_slice"], out["ddim path, warm"]["s_per_slice"]
    print(f"fast path: stage 2 {fast:.4f} s/slice (DPM-{FAST_CFG['ddim_steps']}) against "
          f"DDIM-{TWO_STAGE_CFG['ddim_steps']}'s {warm:.4f} warm ({warm / fast:.2f}x) "
          f"and {ddim_path['s_per_slice']:.4f} in the path phase, the process's first 256x256 stage-2 calls "
          f"({ddim_path['s_per_slice'] / fast:.2f}x); variant {out['fast path variant']['s_per_slice']:.4f} s/slice; "
          f"card {card}", flush=True)
    return out


def tiled_path_phase(flash, card: str) -> dict:
    """`SliceLDM.sample_volume` at 512x512 with `configs/sample_two_stage.yml`'s
    stage-2 UNet, patch-tiled 256x256 at stride 128 (9 windows, each at the
    256x256 sites), one slice, DDIM-4: launches = windows x steps x sites."""
    from jointimagegeneration_torch.cli.sample import build_slice_ldm, load_weights
    from jointimagegeneration_torch.diffusion.ddim import DDIMParams
    from jointimagegeneration_torch.diffusion.noise import NoiseSource
    from jointimagegeneration_torch.ops.tiling import _offsets

    s2, seed, steps, size, tile = TWO_STAGE_CFG["stage2"], TWO_STAGE_CFG["seed"], 4, 512, ((256, 256), (128, 128))
    ldm = build_slice_ldm(s2, "cuda")
    load_weights(ldm.unet, None, TWO_STAGE_CFG["fresh_init_noise"], seed + 2)
    ddim = DDIMParams.create(ldm.diffusion, steps)
    gen = torch.Generator(device="cuda").manual_seed(9)
    labels = torch.randint(0, 12, (1, 1, size // 8, size // 8), generator=gen, device="cuda")
    mask = (labels.repeat_interleave(8, 2).repeat_interleave(8, 3) / 11.0)[..., None]  # 8x8 label blocks
    windows = len(_offsets(size, tile[0][0], tile[1][0])) * len(_offsets(size, tile[0][1], tile[1][1]))
    expected = windows * steps * flash_sites(list(tile[0]), s2["unet_config"]["params"], "channel_mult")
    _reset_counts(flash)
    t0 = time.perf_counter()
    with torch.inference_mode():
        vol = ldm.sample_volume(NoiseSource(seed, "cuda"), mask, ddim, tile=tile)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = _counts(flash)
    check(launches == {**{k: 0 for k in launches}, "flash_fwd": expected},
          f"tiled path: launches {launches}, expected {expected} flash_fwd")
    check(tuple(vol.shape) == (1, 1, size, size, 1) and bool(torch.isfinite(vol).all())
          and float(vol.min()) >= 0.0 and float(vol.max()) <= 1.0, f"tiled path: volume {tuple(vol.shape)}")
    print(f"tiled path: 1 slice at {size}x{size}, tile {tile} ({windows} windows), DDIM-{steps}, base 128, bf16: "
          f"{sec:.3f} s, {sec / (windows * steps):.4f} s per window call; flash_fwd launches {expected} = expected; "
          f"card {card}", flush=True)
    del ldm, vol
    torch.cuda.empty_cache()
    return {"launches": expected, "seconds": sec, "windows": windows}


def latent_path_phase(flash, card: str) -> dict:
    """`cli.sample.run` on `configs/sample_ct_ae.yml`'s full widths (LATENT_CT_CFG:
    KL-VAEs ch 128 / 96 at 512x512 in fp32, z 4; the UNet base 160, mult
    (1,2,4,4,5), attention at ds {8,4,2}, head 32, bf16; DDIM-50), cut only in
    depth (4 slices), fresh-init weights.  The launch counts zeroed before it:
    flash_fwd must launch 5 x 50 x 4 times (the five ds-2 sites, 32x32 = 1,024
    tokens) and no other kernel; the CT finite in [0, 1], its three files, a
    finite LPIPS in metrics.json.  Prints s/slice split into the cond encode,
    the latent chain and the decode (each encode and decode between two
    synchronizes), s per UNet call, the peak GiB, and the encode's and
    decode's operations (the convs' 2 x outputs x Cin x taps and the
    attention's 4 T^2 C + 8 T C^2, counted by forward hooks on this run's
    modules) with the rate they ran at."""
    from jointimagegeneration_torch.cli.sample import run
    from jointimagegeneration_torch.models.latent_ldm import LatentSliceLDM
    from jointimagegeneration_torch.nn.blocks import AttentionBlock, Conv
    from jointimagegeneration_torch.nn.unet import UNet

    cfg = json.loads(json.dumps(LATENT_CT_CFG))
    cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / "latent_ct")
    s2 = cfg["stage2"]
    depth, size = s2["dataset"]["depth"], s2["slice_size"]
    lat = size // 2 ** (len(s2["first_stage"]["ddconfig"]["ch_mult"]) - 1)
    calls = cfg["ddim_steps"] * depth
    expected = calls * flash_sites([lat, lat], s2["unet_config"]["params"], "channel_mult")
    seconds = {"encode_cond": 0.0, "decode": 0.0}
    flops = dict.fromkeys(seconds, 0.0)
    originals = {name: getattr(LatentSliceLDM, name) for name in seconds}
    active = []

    def timed(name):
        def wrapper(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            active.append(name)
            y = originals[name](self, *args, **kw)
            active.pop()
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            return y

        return wrapper

    def count_ops(m, args, y):
        if active and isinstance(m, Conv):
            flops[active[-1]] += 2.0 * y.numel() * m.weight[0].numel()
        elif active and isinstance(m, AttentionBlock):
            b, t, c = args[0].shape[0], math.prod(args[0].shape[1:-1]), args[0].shape[-1]
            flops[active[-1]] += 4.0 * b * t * t * c + 8.0 * b * t * c * c

    unet_calls = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, _: unet_calls.append(1) if isinstance(m, UNet) else None)
    op_hook = torch.nn.modules.module.register_module_forward_hook(count_ops)
    _reset_counts(flash)
    torch.cuda.reset_peak_memory_stats()
    try:
        for name in seconds:
            setattr(LatentSliceLDM, name, timed(name))
        t0 = time.perf_counter()
        result = run(cfg, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(LatentSliceLDM, name, fn)
        hook.remove()
        op_hook.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _counts(flash)
    check(counts == {**{k: 0 for k in counts}, "flash_fwd": expected},
          f"latent path: launches {counts}, expected {expected} flash_fwd and nothing else")
    check(len(unet_calls) == calls, f"latent path: {len(unet_calls)} UNet calls, expected {calls}")
    ct = result["ct"]
    check(ct.shape == (1, depth, size, size) and bool(np.isfinite(ct).all()), f"latent path: CT {ct.shape}")
    check(float(ct.min()) >= 0.0 and float(ct.max()) <= 1.0, f"latent path: CT outside [0, 1]: {ct.min()} {ct.max()}")
    case = Path(cfg["output_path"]) / "case_0000"
    for name in ("image.nii.gz", "image.png", "overlay.png"):
        check((case / name).stat().st_size > 352, f"latent path: {name} not written")
    metrics = json.loads((Path(cfg["output_path"]) / "metrics.json").read_text())
    lpips = metrics["lpips_three_view_mean"]
    check(math.isfinite(lpips) and lpips > 0, f"latent path: LPIPS {lpips}")
    stage2 = result["seconds"]["stage2"]
    enc, dec = seconds["encode_cond"], seconds["decode"]
    chain = stage2 - enc - dec
    print(f"latent path: {depth} slices at {size}x{size} (latent {lat}x{lat}x4), DDIM-{cfg['ddim_steps']}, UNet base "
          f"160 bf16, KL-VAEs fp32: {stage2 / depth:.4f} s/slice = cond encode {enc / depth:.4f} + latent chain "
          f"{chain / depth:.4f} + decode {dec / depth:.4f} (+ min-max); {chain / calls:.4f} s per UNet call "
          f"({calls} calls); peak {peak:.2f} GiB; run() wall {wall:.3f} s (incl. model init, NIfTI, PNGs, LPIPS); "
          f"lpips_3view {lpips:.4f} (uncalibrated VGG, random weights); flash_fwd launches {expected} = expected; "
          f"card {card}", flush=True)
    print(f"latent path: fp32 AEs per slice: cond encode {flops['encode_cond'] / depth / 1e12:.3f} TFLOP at "
          f"{flops['encode_cond'] / enc / 1e12:.1f} TFLOP/s, decode {flops['decode'] / depth / 1e12:.3f} TFLOP at "
          f"{flops['decode'] / dec / 1e12:.1f} TFLOP/s (TF32 off; fp32 peak {PEAK_FLOPS[torch.float32] / 1e12:.0f})",
          flush=True)
    torch.cuda.empty_cache()
    return {"launches": expected, "s_per_slice": stage2 / depth, "encode_s_per_slice": enc / depth,
            "chain_s_per_slice": chain / depth, "decode_s_per_slice": dec / depth, "s_per_unet_call": chain / calls,
            "encode_tflop": flops["encode_cond"] / depth / 1e12, "decode_tflop": flops["decode"] / depth / 1e12,
            "peak_gib": peak, "wall_s": wall, "lpips_three_view": lpips}


def _counts(flash) -> dict:
    from jointimagegeneration_torch.ops import conv3d as conv

    return {"flash_fwd": flash.flash_forward.launches, "flash_fwd_merge": flash.flash_fwd_merge.launches,
            "flash_bwd_dkv": flash.flash_bwd_dkv.launches,
            "flash_bwd_dq": flash.flash_bwd_dq.launches, "flash_bwd_reduce": flash.flash_bwd_reduce.launches,
            "conv3d": conv.conv3d_igemm.launches,
            "conv3d_splitk_reduce": conv.conv3d_igemm.splitk_launches,
            "conv3d_stats_reduce": conv.channel_stats_reduce.launches}


def _reset_counts(flash) -> None:
    from jointimagegeneration_torch.ops import conv3d as conv

    flash.flash_forward.launches = flash.flash_bwd_dkv.launches = flash.flash_bwd_dq.launches = 0
    flash.flash_bwd_reduce.launches = flash.flash_fwd_merge.launches = 0
    conv.conv3d_igemm.launches = conv.conv3d_igemm.splitk_launches = conv.channel_stats_reduce.launches = 0


FUSED_REF_TOL = 1e-4  # card vs CPU, fp32: of each tensor's max |CPU value| (sums in another order)
TINY_FUSED = dict(num_classes=4, time_steps=20, model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,),
                  num_res_blocks=1, num_head_channels=4)


def _rel(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    return (got.cpu() - want).abs().max().item() / max(want.abs().max().item(), floor, 1e-30)


def fused_reference_phase(flash) -> dict:
    """Tiny fp32 fused MaskSamplers ('kernel' and 'xla'; 4x16x16, so every
    ResBlock fuses) on the card against the CPU with the same weights and
    draws: the UNet's probabilities and 3 sampling steps' labels.  Then the
    forward and backward of one fp32 fused ResBlock (64 -> 64) on the card
    against the CPU: the backward is the plain recompute, so this holds the
    autograd wiring around the kernel."""
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.models.mask_sampler import MaskSampler
    from jointimagegeneration_torch.nn.blocks import ResBlock
    from jointimagegeneration_torch.ops import conv3d as conv

    configure_precision()
    shape, steps = (1, 4, 16, 16), 3
    gen = torch.Generator().manual_seed(11)
    xt = torch.nn.functional.one_hot(torch.randint(0, 4, shape, generator=gen), 4).float()
    cond = torch.rand((*shape, 1), generator=gen)
    t = torch.tensor([13.0])
    out = {}
    for mode in ("kernel", "xla"):
        runs, init = [], None
        for device in ("cpu", "cuda"):
            ms = MaskSampler.create(cond_channels=1, use_fused_resblock=mode, device=device, **TINY_FUSED)
            if init is None:
                with torch.no_grad():
                    for p in ms.unet.parameters():
                        p.add_(0.05 * torch.randn(p.shape, generator=gen))  # un-zero every kernel
                init = {k: v.clone() for k, v in ms.unet.state_dict().items()}
            else:
                ms.unet.load_state_dict(init)
            before = _counts(flash)
            with torch.inference_mode():
                probs = ms.unet(xt.to(device), t.to(device), cond=cond.to(device))
                labels = ms.sample_labels(_CpuDrawnNoise(3, device), shape, cond=cond.to(device),
                                          num_steps=steps)
            launched = {k: v - before[k] for k, v in _counts(flash).items()}
            runs.append((probs.cpu(), labels.cpu(), launched))
        (p_cpu, l_cpu, n_cpu), (p_gpu, l_gpu, n_gpu) = runs
        tiny = {"base_channels": TINY_FUSED["model_channels"], "channel_mult": list(TINY_FUSED["channel_mult"]),
                "num_res_blocks": TINY_FUSED["num_res_blocks"]}
        calls = fused_conv_calls(tiny, shape[1:], mode)
        check(len(calls) == 16, f"fused reference: {len(calls)} convs a forward, expected 16 (8 ResBlocks)")
        want = {k: (1 + steps) * v for k, v in planned_launches(conv, calls, torch.float32).items()}
        check(not any(n_cpu.values()), f"fused reference ({mode}): kernel launches on the CPU {n_cpu}")
        check(all(n_gpu[k] == v for k, v in want.items()),
              f"fused reference ({mode}): launches on the card {n_gpu}, expected {want}")
        err = _rel(p_gpu, p_cpu)
        agree = float((l_gpu == l_cpu).float().mean())
        print(f"fused reference ({mode}): tiny fp32 MaskSampler, card vs CPU: probabilities max rel diff "
              f"{err:.3g} (tol {FUSED_REF_TOL}), labels after {steps} steps agree on {100 * agree:.2f}% of "
              f"voxels; launches on the card {n_gpu}", flush=True)
        check(err <= FUSED_REF_TOL and agree >= 0.999, f"fused reference ({mode}): card and CPU disagree")
        out[mode] = err

    x = torch.randn((1, 4, 16, 16, 64), generator=gen)
    emb = torch.randn((1, 32), generator=gen)
    w = torch.randn((1, 4, 16, 16, 64), generator=gen)
    res, init = [], None
    for device in ("cpu", "cuda"):
        blk = ResBlock(64, 64, 32, 3, fused="kernel", device=device)
        if init is None:
            with torch.no_grad():
                for p in blk.parameters():
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
            init = {k: v.clone() for k, v in blk.state_dict().items()}
        else:
            blk.load_state_dict(init)
        xd = x.detach().to(device).requires_grad_()
        before = _counts(flash)["conv3d"]
        y = blk(xd, emb.to(device))
        (y * w.to(device)).sum().backward()
        grads = {n: q.grad.detach().cpu() for n, q in blk.named_parameters()}
        grads["x"] = xd.grad.cpu()
        res.append((y.detach().cpu(), grads, _counts(flash)["conv3d"] - before))
    (y_cpu, g_cpu, n_cpu), (y_gpu, g_gpu, n_gpu) = res
    top = max(v.abs().max().item() for v in g_cpu.values())
    worst_g = max(_rel(g_gpu[n], g_cpu[n], 1e-3 * top) for n in g_cpu)
    err_y = _rel(y_gpu, y_cpu)
    print(f"fused reference: fp32 ResBlock 64->64 ('kernel'), card vs CPU: output max rel diff {err_y:.3g}, "
          f"worst gradient {worst_g:.3g} of its max (tol {FUSED_REF_TOL}); conv launches cpu {n_cpu}, "
          f"card {n_gpu}", flush=True)
    check(n_cpu == 0 and n_gpu == 2, f"fused reference: ResBlock conv launches cpu {n_cpu}, card {n_gpu}")
    check(err_y <= FUSED_REF_TOL and worst_g <= FUSED_REF_TOL, "fused reference: the ResBlock disagrees")
    out["resblock_out"], out["resblock_grad"] = err_y, worst_g
    return out


def pallas_conv_sites(unet) -> int:
    """Convs of one UNet forward that `_raw_conv` routes to the kernel under
    `use_pallas_conv`: 3x3x3 at Cin = 128 and H >= 64 (H % 8 == 0), from each
    ResBlock's level (H = input H / 2^level) and its conv inputs (in_ch for
    conv1, out_ch for conv2)."""
    from jointimagegeneration_torch.nn.blocks import ResBlock

    h0, n = TWO_STAGE_CFG["stage1"]["dataset"]["volume_shape"][1], 0
    for name, blk in unet.named_children():
        if isinstance(blk, ResBlock):
            level = len(unet.channel_mult) - 1 if name.startswith("mid") else int(name.split("_")[1])
            h = h0 // 2 ** level
            if h >= 64 and h % 8 == 0:
                n += (blk.in_ch == 128) + (blk.out_ch == 128)
    return n


def fused_path_phase(flash, card: str) -> dict:
    """The fused stage-1 path at `configs/sample_two_stage.yml`'s full width:
    `MaskSampler.create(..., use_fused_resblock=mode)` for 'kernel' and 'xla',
    and `use_pallas_conv=True`, each sampling 4 steps at 64x128x128 (bf16)
    with the same weights (fresh init, zero-init kernels filled as the path
    phase does) and the same draws as the unfused model in this call.  Checks
    the exact launch counts, which the launch planner gives for each conv
    call of a forward (`fused_conv_calls`, whose ResBlock channels are held
    against the built UNet's); holds one forward's probabilities against an
    fp32 unfused forward: each bf16 variant may be at most twice as far from
    it as the bf16 unfused model is, plus 1e-3 (the variants round at other
    places, and by as much).  Then the 'kernel' path in fp32
    (`_fused_f32_run`)."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler, load_weights
    from jointimagegeneration_torch.diffusion.noise import NoiseSource
    from jointimagegeneration_torch.nn.blocks import ResBlock
    from jointimagegeneration_torch.ops import conv3d as conv

    s1, steps, seed = TWO_STAGE_CFG["stage1"], 4, TWO_STAGE_CFG["seed"]
    spatial = tuple(s1["dataset"]["volume_shape"])
    shape = (1, *spatial)
    base = build_mask_sampler(s1, "cuda")
    load_weights(base.unet, None, TWO_STAGE_CFG["fresh_init_noise"], seed + 1)
    state = base.unet.state_dict()
    n_res = sum(isinstance(m, ResBlock) for m in base.unet.children())
    sites = flash_sites(spatial, s1["unet_openai"], "channel_mult")
    n_pallas = pallas_conv_sites(base.unet)
    check(n_res == 27 and n_pallas == 8, f"fused path: {n_res} ResBlocks, {n_pallas} pallas_conv sites")
    built = [(b.in_ch, b.out_ch) for b in base.unet.children() if isinstance(b, ResBlock)]
    check(built == [(i, o) for _, i, o in resblock_channels(s1["unet_openai"])],
          f"fused path: the UNet's ResBlocks {built} are not resblock_channels'")
    l1 = tuple(s // 2 for s in spatial)  # the pallas_conv sites: 128 -> 128 at level 1
    per_step = {"unfused": {}, "pallas_conv": planned_launches(conv, [((1, *l1, 128), 128, "")] * n_pallas)}
    for mode in ("kernel", "xla"):
        per_step[mode] = planned_launches(conv, fused_conv_calls(s1["unet_openai"], spatial, mode))
    per_step["kernel fp32"] = planned_launches(conv, fused_conv_calls(s1["unet_openai"], spatial, "kernel"),
                                               torch.float32)
    print(f"fused path: planned launches per step {per_step}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    xt = torch.nn.functional.one_hot(torch.randint(0, 12, shape, generator=gen, device="cuda"), 12).float()
    cond = torch.zeros((*shape, 1), device="cuda")
    t = torch.full((1,), 500.0, device="cuda")
    with torch.inference_mode():
        ref = build_mask_sampler({**s1, "bf16": False}, "cuda")
        ref.unet.load_state_dict(state)
        p32 = ref.unet(xt, t, cond=cond).float()
    del ref
    torch.cuda.empty_cache()
    variants = [("unfused", {}), ("kernel", {"use_fused_resblock": "kernel"}), ("xla", {"use_fused_resblock": "xla"}),
                ("pallas_conv", {"use_pallas_conv": True})]
    rows, p_unfused, lab_unfused = {}, None, None
    for name, opts in variants:
        ms = base if name == "unfused" else build_mask_sampler(s1, "cuda", **opts)
        ms.unet.load_state_dict(state)
        with torch.inference_mode():
            probs = ms.unet(xt, t, cond=cond).float()  # also the warm-up
            torch.cuda.synchronize()
            _reset_counts(flash)
            t0 = time.perf_counter()
            labels = ms.sample_labels(NoiseSource(seed, "cuda"), shape, cond=cond, num_steps=steps)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        launches = _counts(flash)
        expected = {"flash_fwd": steps * sites, "flash_fwd_merge": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                    "flash_bwd_reduce": 0,
                    **{k: steps * per_step[name].get(k, 0) for k in
                       ("conv3d", "conv3d_splitk_reduce", "conv3d_stats_reduce")}}
        check(launches == expected, f"fused path ({name}): launches {launches}, expected {expected}")
        check(tuple(labels.shape) == shape and int(labels.min()) >= 0 and int(labels.max()) < 12,
              f"fused path ({name}): labels {tuple(labels.shape)} in [{labels.min()}, {labels.max()}]")
        check(bool(torch.isfinite(probs).all()), f"fused path ({name}): non-finite probabilities")
        e32 = (probs - p32).abs().max().item()
        agree32 = float((probs.argmax(-1) == p32.argmax(-1)).float().mean())
        if p_unfused is None:
            p_unfused, lab_unfused, e_unfused, agree_unfused = probs, labels, e32, agree32
        d_unfused = (probs - p_unfused).abs().max().item()
        agree_u = float((probs.argmax(-1) == p_unfused.argmax(-1)).float().mean())
        lab_agree = float((labels == lab_unfused).float().mean())
        rows[name] = {"s_per_step": sec / steps, "launches": launches, "max_abs_vs_fp32": e32,
                      "argmax_agree_fp32": agree32, "max_abs_vs_unfused": d_unfused,
                      "argmax_agree_unfused": agree_u, "sampled_labels_agree_unfused": lab_agree}
        print(f"fused path ({name}): 4 steps at 64x128x128, base 64, bf16: {sec / steps:.4f} s/step; probs "
              f"max abs diff vs fp32 unfused {e32:.3g} (argmax agree {100 * agree32:.2f}%), vs bf16 unfused "
              f"{d_unfused:.3g} (argmax agree {100 * agree_u:.2f}%); sampled labels agree with unfused on "
              f"{100 * lab_agree:.2f}%; launches {launches} = expected; card {card}", flush=True)
        if name != "unfused":
            check(e32 <= 2 * e_unfused + 1e-3, f"fused path ({name}): {e32} from fp32, unfused bf16 {e_unfused}")
            check(agree32 >= agree_unfused - 0.02,
                  f"fused path ({name}): argmax agrees with fp32 on {agree32}, unfused bf16 {agree_unfused}")
            del ms
        torch.cuda.empty_cache()
    del base
    gc.collect()
    torch.cuda.empty_cache()
    rows["kernel fp32"] = _fused_f32_run(flash, conv, s1, state, xt, t, cond, p32,
                                         per_step["kernel fp32"], sites, card)
    return rows


FUSED_F32_STEPS = 2


def _fused_f32_run(flash, conv, s1: dict, state: dict, xt, t, cond, p32, per_step: dict, sites: int,
                   card: str) -> dict:
    """The fused 'kernel' path in fp32 (the stage-1 config with `bf16: false`,
    as a sampling config sets it): one forward's probabilities against the
    fp32 unfused forward `p32` (within FUSED_REF_TOL of max |p|: the two
    differ in GroupNorm's one-pass moments and the summation order), the conv
    device ms per UNet level over that forward (CUDA events around each conv
    call's launches), then FUSED_F32_STEPS sampling steps with the unfused
    model's weights and draws: s/step, peak GiB and the exact launches (the
    fp32 planner's, with its split-K reduces; the flash sites in fp32)."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    steps, seed = FUSED_F32_STEPS, TWO_STAGE_CFG["seed"]
    shape = tuple(xt.shape[:4])
    ms = build_mask_sampler({**s1, "bf16": False}, "cuda", use_fused_resblock="kernel")
    ms.unet.load_state_dict(state)
    by_level, real_launch = {}, conv._launch_plan

    def timed_launch(plan, fn, ptrs, x_shape, cout, *rest):  # device time of each conv call's launches
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        real_launch(plan, fn, ptrs, x_shape, cout, *rest)
        ev[1].record()
        by_level.setdefault(int(round(math.log2(shape[1] / x_shape[1]))), []).append(ev)

    with torch.inference_mode():
        ms.unet(xt, t, cond=cond)  # the warm-up
        conv._launch_plan = timed_launch
        try:
            probs = ms.unet(xt, t, cond=cond)
        finally:
            conv._launch_plan = real_launch
        torch.cuda.synchronize()
        conv_ms = {lv: sum(a.elapsed_time(b) for a, b in evs) for lv, evs in sorted(by_level.items())}
        err = _rel(probs, p32.cpu())
        agree = float((probs.argmax(-1) == p32.argmax(-1)).float().mean())
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(flash)
        t0 = time.perf_counter()
        labels = ms.sample_labels(NoiseSource(seed, "cuda"), shape, cond=cond, num_steps=steps)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _counts(flash)
    t8 = math.prod(shape[1:]) // 8**3  # the flash sites: ds 8, 8 heads of 32
    merges = steps * sites * fwd_merges(flash, 8, t8, t8, 32) if sites else 0
    expected = {"flash_fwd": steps * sites, "flash_fwd_merge": merges, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                "flash_bwd_reduce": 0, **{k: steps * v for k, v in per_step.items()}}
    check(launches == expected, f"fused path (kernel fp32): launches {launches}, expected {expected}")
    check(tuple(labels.shape) == shape and int(labels.min()) >= 0 and int(labels.max()) < 12,
          f"fused path (kernel fp32): labels {tuple(labels.shape)}")
    check(bool(torch.isfinite(probs).all()) and err <= FUSED_REF_TOL,
          f"fused path (kernel fp32): probabilities {err} of max |p| from the fp32 unfused forward")
    print(f"fused path (kernel fp32): {steps} steps at 64x128x128, base 64, fp32: {sec / steps:.4f} s/step, peak "
          f"torch.cuda.max_memory_allocated {peak:.2f} GiB; probs max abs diff vs fp32 unfused {err:.3g} of max |p| "
          f"(tol {FUSED_REF_TOL}), argmax agree {100 * agree:.2f}%; conv device ms per level in one forward "
          f"{ {lv: round(v, 4) for lv, v in conv_ms.items()} } (sum {sum(conv_ms.values()):.4f}); launches "
          f"{launches} = expected; card {card}", flush=True)
    del ms
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_per_step": sec / steps, "peak_gib": peak, "launches": launches, "max_rel_vs_fp32": err,
            "argmax_agree_fp32": agree, "conv_ms_by_level": conv_ms}


def _reference_steps(flash, label: str, device: str, named, step, batches) -> tuple:
    """Run `step` (SGD 1e-2, EMA 0.9) on `batches` in turn, recording each
    step's gradients as apply_gradients receives them: (losses, gradients,
    params after each step, kernel launches)."""
    from jointimagegeneration_torch.train.optim import build_optimizer
    from jointimagegeneration_torch.train.state import EMATrainState

    state = EMATrainState(build_optimizer(named, "SGD", 1e-2), ema_decay=0.9)
    grads, apply = [], state.apply_gradients

    def record(g, apply=apply, grads=grads):  # keep each step's gradients, then apply them
        grads.append({k: v.detach().cpu() for k, v in g.items()})
        return apply(g)

    state.apply_gradients = record
    noise = _CpuDrawnNoise(9, device)
    before = _counts(flash)
    losses, params = [], []
    for batch in batches:
        metrics = step(state, {k: v.to(device) for k, v in batch.items()}, noise)
        check(float(metrics["grad_finite"]) == 1.0, f"{label}: non-finite gradients on {device}")
        losses.append(float(metrics["loss"]))
        params.append({n: p.detach().cpu().clone() for n, p in zip(state.names, state.params)})
    return losses, grads, params, {k: v - before[k] for k, v in _counts(flash).items()}


def _compare_reference_steps(runs, label: str) -> dict:
    """Worst relative card-vs-CPU difference of the losses, gradients and
    params of `_reference_steps`' two runs; fails past TRAIN_REF_TOL."""
    (l_cpu, g_cpu, p_cpu, _), (l_gpu, g_gpu, p_gpu, _) = runs
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for i in range(len(l_cpu)):
        worst["loss"] = max(worst["loss"], abs(l_gpu[i] - l_cpu[i]) / abs(l_cpu[i]))
        for kind, got, want in (("grad", g_gpu[i], g_cpu[i]), ("param", p_gpu[i], p_cpu[i])):
            for n, w in want.items():
                rel = (got[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                worst[kind] = max(worst[kind], rel)
                check(rel <= TRAIN_REF_TOL, f"{label}: step {i + 1} {kind} {n} differs by {rel:.3g} "
                                            f"of its max (tol {TRAIN_REF_TOL})")
    check(worst["loss"] <= TRAIN_REF_TOL, f"{label}: losses {l_gpu} vs {l_cpu}")
    return worst


def fwd_merges(flash, bh: int, tq: int, tk: int, d: int) -> int:
    """Merge launches of one fp32 flash forward call: one where
    `plan_flash_fwd` splits its key loop."""
    return flash.plan_flash_fwd(bh, tq, tk, d, torch.float32).merge_launches


def call_merges(flash, calls) -> int:
    """Merge launches of fp32 flash forward calls of these (BH, T, D) shapes
    (self-attention; D padded to a multiple of 4, as the wrapper pads it)."""
    return sum(fwd_merges(flash, bh, t, t, -(-d // 4) * 4) for bh, t, d in calls)


def stage1_merges(flash, s1: dict, ctx_len: int) -> int:
    """flash_fwd_merge launches of one stage-1 chain: the refiner's fp32
    sites (`stage1_launches(s1, 0, ctx_len)`, 0 where its context does not
    take the flash rule) times the merges of one of its calls (a bf16 UNet
    site never merges)."""
    fce = s1.get("feature_cond_encoder") or {}
    sites = stage1_launches(s1, 0, ctx_len)
    return sites * fwd_merges(flash, fce.get("n_heads", 8), ctx_len, ctx_len, fce.get("d_head", 64)) if sites else 0


def bwd_reduces(flash, bh: int, tq: int, tk: int, d: int) -> int:
    """Split-reduce launches of one fp32 flash backward call: one for each of
    dkv and dq whose streamed loop `plan_flash_bwd` splits."""
    plan = flash.plan_flash_bwd(bh, tq, tk, d, torch.float32)
    return plan.dkv.reduce_launches + plan.dq.reduce_launches


def _check_flash_only(runs, label: str, reduces_per_bwd: int = None) -> dict:
    """The card's run launched all three flash kernels (and, given
    `reduces_per_bwd`, that many split reduces per backward) and no conv
    kernel; the CPU's launched nothing."""
    n_cpu, n_gpu = runs[0][3], runs[1][3]
    check(not any(n_cpu.values()) and all(n_gpu[k] for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
          and n_gpu["conv3d"] == n_gpu["conv3d_splitk_reduce"] == n_gpu["conv3d_stats_reduce"] == 0
          and (reduces_per_bwd is None or n_gpu["flash_bwd_reduce"] == reduces_per_bwd * n_gpu["flash_bwd_dq"]),
          f"{label}: kernel launches cpu {n_cpu}, card {n_gpu}")
    return n_gpu


def train_reference_phase(flash) -> dict:
    """Three fp32 train steps (make_mask_train_step) on the card against the
    same steps on the CPU: same weights, same data, same draws.  Returns the
    worst relative difference.  The optimizer is SGD: Adam would normalise
    the rounding noise on the attention's key bias (whose gradient softmax
    cancels exactly) up to +-lr, and this phase holds the kernels, not Adam."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.data.datasets import SyntheticMaskDataset
    from jointimagegeneration_torch.train.steps import make_mask_train_step

    configure_precision()
    cfg = {"num_classes": 4, "time_steps": 20, "bf16": False, "unet_openai": TRAIN_REF_UNET}
    ds = SyntheticMaskDataset(3, (8, 8, 8), 4)
    gen = torch.Generator().manual_seed(5)
    conds = [torch.rand((1, 8, 8, 8, 1), generator=gen) for _ in range(3)]
    batches = [{"mask": torch.from_numpy(ds[i]["mask"])[None], "image": conds[i]} for i in range(3)]
    runs, init = [], None
    for device in ("cpu", "cuda"):
        model = build_mask_sampler(cfg, device)
        if init is None:
            with torch.no_grad():
                for p in model.unet.parameters():
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))  # un-zero every kernel
            init = {k: v.clone() for k, v in model.unet.state_dict().items()}  # training moves the CPU params
        else:
            model.unet.load_state_dict(init)
        step = make_mask_train_step(model, torch.ones(4, device=device))
        named = list(model.unet.named_parameters())
        runs.append(_reference_steps(flash, "train reference", device, named, step, batches))
    n_gpu = _check_flash_only(runs, "train reference", bwd_reduces(flash, 4, 512, 512, 16))  # 4 heads of 16
    worst = _compare_reference_steps(runs, "train reference")
    print(f"train reference: 3 fp32 steps (base 64, T = 512 at the attention sites), card vs CPU: worst "
          f"relative diff loss {worst['loss']:.3g}, gradient {worst['grad']:.3g}, params {worst['param']:.3g} "
          f"(tol {TRAIN_REF_TOL}); launches on the card {n_gpu}", flush=True)
    return {"max_rel_err": max(worst.values()), "launches": n_gpu}


def ldm_train_reference_phase(flash) -> dict:
    """Three fp32 stage-2 train steps (make_ldm_train_step, with a learned
    logvar and the elbo term) of a small 2D SliceLDM on the card against the
    same steps on the CPU: same weights, same slices, same draws (t, then the
    noise).  Every parameter, logvar included, is un-zeroed first: a fresh
    UNet's zero output conv would block every upstream gradient.  SGD, for
    the reason train_reference_phase gives.  Returns the worst relative
    difference and the card's launches."""
    from jointimagegeneration_torch.cli.sample import build_slice_ldm
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.data.datasets import SyntheticSliceDataset
    from jointimagegeneration_torch.train.steps import make_ldm_train_step

    configure_precision()
    cfg = {"bf16": False, "unet_config": {"params": LDM_REF_UNET}}
    ds = SyntheticSliceDataset(3, (32, 32), depth=4)
    batches = [{k: torch.from_numpy(item[k])[None] for k in ("image", "cond")} for item in (ds[i] for i in range(3))]
    gen = torch.Generator().manual_seed(6)
    runs, init = [], None
    for device in ("cpu", "cuda"):
        model = build_slice_ldm(cfg, device, learn_logvar=True)
        named = model.named_parameters()
        with torch.no_grad():
            if init is None:
                for _, p in named:
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))  # un-zero every kernel
                init = {n: p.detach().clone() for n, p in named}  # training moves the CPU params
            else:
                for n, p in named:
                    p.copy_(init[n])
        step = make_ldm_train_step(model, elbo_weight=0.25)
        runs.append(_reference_steps(flash, "ldm train reference", device, named, step, batches))
    n_gpu = _check_flash_only(runs, "ldm train reference", bwd_reduces(flash, 4, 1024, 1024, 16))
    worst = _compare_reference_steps(runs, "ldm train reference")
    print(f"ldm train reference: 3 fp32 stage-2 steps (base 64, learned logvar, T = 1024 at the attention "
          f"sites), card vs CPU: worst relative diff loss {worst['loss']:.3g}, gradient {worst['grad']:.3g}, "
          f"params {worst['param']:.3g} (tol {TRAIN_REF_TOL}); launches on the card {n_gpu}", flush=True)
    return {"max_rel_err": max(worst.values()), "launches": n_gpu}


def _train_run(flash, run, cfg: dict, exp: str) -> tuple:
    """One trainer `run` (`cli.train_mask.run` or `cli.train_ldm.run`) with the
    launch counts zeroed before it: (state, launches, wall seconds, stdout)."""
    out = io.StringIO()
    _reset_counts(flash)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = run(cfg, exp, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(flash)
    sys.stdout.write(out.getvalue())
    return state, launches, wall, out.getvalue()


def train_path_phase(flash, card: str, base: dict = STAGE1_TRAIN_CFG, label: str = "train path",
                     subdir: str = "train", resume: bool = True) -> dict:
    """Stage-1 training at full width through `cli.train_mask.run`, then (with
    `resume`) a resumed run; returns the first run's launch counts and
    numbers.  With a `selfattn` encoder (the text train paths) each flash
    site launches twice (attn1, attn2), a context the flash rule takes adds
    the refiner's fp32 sites (2 per block, each backward with its split
    reduces), every refiner parameter must move, the device time of the fp32
    flash backward calls is summed (CUDA events around each), and the
    checkpoints under build/chip_smoke/<subdir> are deleted at the end.  The
    long-report run (TEXT_LONG_TRAIN_CFG, a 640-token context) cuts its own
    length to keep the smoke's: 3 steps, one checkpoint, no validation and
    no resume."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler
    from jointimagegeneration_torch.cli.train_mask import run
    from jointimagegeneration_torch.core.checkpoint import CheckpointManager

    cfg = json.loads(json.dumps(base))
    cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / subdir)
    shutil.rmtree(cfg["output_path"], ignore_errors=True)
    logdir = Path(cfg["output_path"]) / "smoke"
    fce = cfg.get("feature_cond_encoder") or {}
    text = fce.get("type") == "selfattn"
    ctx_len = cfg["dataset"].get("context_len", 4) if text else 0
    sites = stage1_launches(cfg, 1, ctx_len)  # launches of a train step's forward, each with its backward
    refiner_sites = stage1_launches(cfg, 0, ctx_len)  # the fp32 ones among them
    reduces = refiner_sites * (bwd_reduces(flash, fce.get("n_heads", 8), ctx_len, ctx_len, fce.get("d_head", 64))
                               if refiner_sites else 0)
    n_steps, n_eval = cfg["max_steps"], cfg["max_steps"] // cfg["validation_freq_steps"]
    expected = {"flash_fwd": sites * n_steps + n_eval * stage1_launches(cfg, cfg["eval_time_steps"], ctx_len),
                "flash_fwd_merge": (n_steps + n_eval) * stage1_merges(flash, cfg, ctx_len),
                "flash_bwd_dkv": sites * n_steps, "flash_bwd_dq": sites * n_steps,
                "flash_bwd_reduce": reduces * n_steps,
                "conv3d": 0, "conv3d_splitk_reduce": 0, "conv3d_stats_reduce": 0}  # the unfused UNet
    events, real_backward = [], flash.flash_backward

    def timed_backward(q, *rest):  # device time of the fp32 backward calls, between CUDA events
        if q.dtype != torch.float32:
            return real_backward(q, *rest)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real_backward(q, *rest)
        ev[1].record()
        events.append(ev)
        return out

    torch.cuda.reset_peak_memory_stats()
    flash.flash_backward = timed_backward
    try:
        state, launches, wall, _ = _train_run(flash, run, cfg, "smoke")
    finally:
        flash.flash_backward = real_backward
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    f32_bwd_ms = sum(s.elapsed_time(e) for s, e in events) / n_steps
    check(launches == expected, f"{label}: launches {launches}, expected {expected}")
    check(len(events) == refiner_sites * n_steps, f"{label}: {len(events)} fp32 backward calls timed")
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    check([r["step"] for r in train] == list(range(1, n_steps + 1)), f"{label}: logged steps {train}")
    check(all(math.isfinite(r["train/loss"]) for r in train), f"{label}: a logged loss is not finite")
    check(all(r["train/grad_finite"] == 1.0 and r["train/nonfinite_skipped"] == 0.0 for r in train),
          f"{label}: a step had non-finite gradients")
    dice = [r["val/dice"] for r in recs if "val/dice" in r and r["step"] == n_steps]
    check(len(dice) == n_eval and all(0.0 <= x <= 1.0 for x in dice), f"{label}: val/dice at step {n_steps}: {dice}")
    steps = CheckpointManager(logdir / "checkpoints").all_steps()
    want_steps = list(range(cfg["save_freq"], n_steps + 1, cfg["save_freq"]))
    check(steps["rolling"] == want_steps and steps["best"] == ([n_steps] if n_eval else []),
          f"{label}: checkpoints {steps}")
    fresh = dict(build_mask_sampler(cfg, "cuda", seed=cfg["seed"]).named_parameters())
    moved = {n: (p - fresh[n]).abs().max().item() > 0 for n, p in zip(state.names, state.params)}
    check(sum(moved.values()) > 0.9 * len(moved), f"{label}: only {sum(moved.values())} of {len(moved)} params moved")
    refiner = [n for n in moved if n.startswith("refiner.")]
    check(len(refiner) == (20 * fce.get("model_depth", 4) if text else 0)
          and all(moved[n] for n in refiner), f"{label}: refiner params {len(refiner)}, moved "
                                              f"{sum(moved[n] for n in refiner)}")
    ema_off = max((e - p).abs().max().item() for e, p in zip(state.ema, state.params))
    check(ema_off > 0, f"{label}: the EMA equals the params")
    sec = sorted(r["train/step_seconds"] for r in train[1:])  # step 1 carries cuDNN's first-call setup
    s_per_step = sec[len(sec) // 2]
    what = f"text, context {ctx_len} x {fce['embed_dim']}, " if text else ""
    val = f"val/dice {dice[0]:.4f}" if dice else "no validation"
    print(f"{label}: stage 1 (64x128x128, base 64, bf16, {what}AdamW + EMA) {n_steps} steps, warmed "
          f"{s_per_step:.4f} s/step (median of steps 2-{n_steps}; step 1 {train[0]['train/step_seconds']:.3f} s), "
          f"losses {[round(r['train/loss'], 2) for r in train]}, {val}, peak "
          f"torch.cuda.max_memory_allocated {peak_gib:.2f} GiB, run() wall {wall:.2f} s (incl. model init, "
          f"validation and checkpoint writes); launches {launches} = expected"
          f"{f'; {len(refiner)} refiner params all moved' if text else ''}"
          f"{f'; fp32 flash backward (the refiner) {f32_bwd_ms:.4f} device ms per step' if events else ''}; card "
          f"{card}", flush=True)
    del state, fresh
    gc.collect()
    torch.cuda.empty_cache()

    if resume:
        cfg2 = dict(cfg, load_from=True, max_steps=n_steps + 2)
        expected2 = {k: (v // n_steps * 2 if k.startswith("flash_bwd") else 0) for k, v in expected.items()}
        expected2["flash_fwd"] = sites * 2
        expected2["flash_fwd_merge"] = 2 * stage1_merges(flash, cfg, ctx_len)
        state2, launches2, wall2, printed = _train_run(flash, run, cfg2, "smoke")
        check(f"resumed from step {n_steps}" in printed, f"{label}: the rerun did not resume from step {n_steps}")
        check(state2.step == n_steps + 2, f"{label}: resumed run ended at step {state2.step}")
        check(launches2 == expected2, f"{label} (resumed): launches {launches2}, expected {expected2}")
        print(f"{label}: resumed from step {n_steps} to {state2.step} in {wall2:.2f} s; launches {launches2} "
              f"= expected", flush=True)
        del state2
        gc.collect()
        torch.cuda.empty_cache()
    if text:
        shutil.rmtree(cfg["output_path"], ignore_errors=True)
    return {"launches": launches, "s_per_step": s_per_step, "peak_gib": peak_gib,
            "val_dice": dice[0] if dice else None, "f32_bwd_ms_per_step": f32_bwd_ms}


def _text_features(path: Path) -> str:
    """A seeded (TEXT_TOKENS, 768) fp32 features file, the form stage 1
    trains and samples on (one BERT chunk of a report)."""
    gen = np.random.default_rng(512)
    np.savez(path, feats=gen.standard_normal((TEXT_TOKENS, TEXT_FCE["embed_dim"])).astype(np.float32))
    return str(path)


def text_reference_phase(flash) -> dict:
    """A tiny fp32 text-conditioned MaskSampler (TRAIN_REF_UNET with
    cross-attention, TEXT_REF_FCE's refiner over a 512-token context) on the
    card against the CPU, same weights and draws: `sample_labels` with a
    label-guidance function, then two train steps with the refiner's dropout
    on (its masks drawn on the CPU for both), each from the un-zeroed init on
    its own batch; then step 2 again, taken on both devices from the card's
    parameters after its step 1 (copied into the CPU model), so the card's
    model is held after an update.  Each device does not take step 2 from
    its own step 1: this model's gradients move ~30x any relative change of
    its weights (a 1e-6 change moved them 3.2e-5 on the CPU), so two states
    that differ by the first update's fp32 rounding would hold that
    amplification, not the kernels, to TRAIN_REF_TOL.  Launches on the card:
    per chain the refiner's 4 fp32 forwards and per UNet call 6 (three
    512-token sites, attn1 and attn2); per train step the same 10 of each
    kernel."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.data.datasets import SyntheticMaskDataset
    from jointimagegeneration_torch.train.steps import make_mask_train_step

    configure_precision()
    cfg = {"num_classes": 4, "time_steps": 20, "bf16": False, "unet_openai": TRAIN_REF_UNET,
           "feature_cond_encoder": TEXT_REF_FCE, "dataset": {"volume_shape": [8, 8, 8]}}
    gen = torch.Generator().manual_seed(8)
    ctx = torch.randn((1, TEXT_TOKENS, TEXT_REF_FCE["embed_dim"]), generator=gen)
    cond = torch.rand((1, 8, 8, 8, 1), generator=gen)
    ds = SyntheticMaskDataset(2, (8, 8, 8), 4)
    batches = [{"mask": torch.from_numpy(ds[i]["mask"])[None], "image": cond, "context": ctx * (1 + i)}
               for i in range(2)]
    sample_steps = 3
    per_call, refine = stage1_launches(cfg, 1, 0), stage1_launches(cfg, 0, TEXT_TOKENS)
    check(per_call == 6 and refine == 4, f"text reference: planned launches {per_call} a call, {refine} a chain")
    runs, labels, sample_launches, init, models = [], [], [], None, {}
    for device in ("cpu", "cuda"):
        model = build_mask_sampler(cfg, device)
        named = model.named_parameters()
        with torch.no_grad():
            if init is None:
                for _, p in named:
                    p.add_(0.02 * torch.randn(p.shape, generator=gen))  # un-zero every kernel
                init = {n: p.detach().clone() for n, p in named}  # training moves the CPU params
            else:
                for n, p in named:
                    p.copy_(init[n])
        before = _counts(flash)
        lab = model.sample_labels(_CpuDrawnNoise(4, device), (1, 8, 8, 8), cond=cond.to(device),
                                  context=ctx.to(device), num_steps=sample_steps, guidance_fn=lambda p: 0.4 * p * p)
        labels.append(lab.cpu().numpy())
        sample_launches.append({k: v - before[k] for k, v in _counts(flash).items()})
        step = make_mask_train_step(model, torch.ones(4, device=device))
        models[device] = (model, named, step)
        steps = []
        for batch in batches:  # each step from the init: see the docstring
            with torch.no_grad():
                for n, p in named:
                    p.copy_(init[n])
            steps.append(_reference_steps(flash, "text reference", device, named, step, [batch]))
        runs.append(([x for s in steps for x in s[0]], [x for s in steps for x in s[1]],
                     [x for s in steps for x in s[2]], {k: sum(s[3][k] for s in steps) for k in steps[0][3]}))
    # merges: the UNet's sites at (4 heads of 16, 512, 512), the refiner's at (2 x 64), both fp32
    m_unet = fwd_merges(flash, 4, TEXT_TOKENS, TEXT_TOKENS, 16)
    m_ref = fwd_merges(flash, TEXT_REF_FCE["n_heads"], TEXT_TOKENS, TEXT_TOKENS, TEXT_REF_FCE["d_head"])
    want = {"flash_fwd": sample_steps * per_call + refine, "flash_fwd_merge": sample_steps * per_call * m_unet
            + refine * m_ref, "flash_bwd_dkv": 0, "flash_bwd_dq": 0, "flash_bwd_reduce": 0, "conv3d": 0,
            "conv3d_splitk_reduce": 0, "conv3d_stats_reduce": 0}
    check(not any(sample_launches[0].values()) and sample_launches[1] == want,
          f"text reference (sample): launches cpu {sample_launches[0]}, card {sample_launches[1]}, expected {want}")
    agree = float(np.mean(labels[0] == labels[1]))
    check(agree >= 0.999, f"text reference (sample): labels agree on {100 * agree:.2f}% of voxels")
    n_gpu = _check_flash_only(runs, "text reference")
    # split reduces a train step: the UNet's sites at (4 heads of 16, 512, 512), the refiner's at (2 x 64)
    reduces = per_call * bwd_reduces(flash, 4, TEXT_TOKENS, TEXT_TOKENS, 16) + refine * bwd_reduces(
        flash, TEXT_REF_FCE["n_heads"], TEXT_TOKENS, TEXT_TOKENS, TEXT_REF_FCE["d_head"])
    step_want = {k: 2 * (per_call + refine) if k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq") else 0
                 for k in n_gpu}
    step_want["flash_bwd_reduce"] = 2 * reduces
    step_want["flash_fwd_merge"] = 2 * (per_call * m_unet + refine * m_ref)
    check(n_gpu == step_want, f"text reference (train): launches {n_gpu}, expected {step_want}")
    worst = _compare_reference_steps(runs, "text reference")
    refiner = max(runs[1][1][0][n].abs().max().item() for n in runs[1][1][0] if n.startswith("refiner."))
    check(refiner > 0, "text reference: the refiner got no gradient")
    after_step1 = runs[1][2][0]  # the card's parameters after its step 1
    stepped = []
    for device in ("cpu", "cuda"):
        model, named, step = models[device]
        with torch.no_grad():
            for n, p in named:
                p.copy_(after_step1[n])
        stepped.append(_reference_steps(flash, "text reference (step 2)", device, named, step, batches[1:]))
    n_stepped = _check_flash_only(stepped, "text reference (step 2)")
    check(n_stepped == {k: v // 2 for k, v in step_want.items()},
          f"text reference (step 2): launches {n_stepped}, expected half of {step_want}")
    worst2 = _compare_reference_steps(stepped, "text reference (step 2 from the card's step 1)")
    print(f"text reference: tiny fp32 text MaskSampler (TRAIN_REF_UNET + cross-attention, a 2-block refiner of "
          f"2 heads x 64 over {TEXT_TOKENS} tokens), card vs CPU: guided sample_labels ({sample_steps} steps) "
          f"agree on {100 * agree:.2f}% of voxels with {sample_launches[1]['flash_fwd']} flash_fwd launches; 2 "
          f"train steps (refiner dropout 0.2) worst relative diff loss {worst['loss']:.3g}, gradient "
          f"{worst['grad']:.3g}, params {worst['param']:.3g} (tol {TRAIN_REF_TOL}); launches {n_gpu}; step 2 "
          f"from the card's step 1 on both: loss {worst2['loss']:.3g}, gradient {worst2['grad']:.3g}, params "
          f"{worst2['param']:.3g}; launches {n_stepped}", flush=True)
    del models
    return {"label_agreement": agree,
            "launches": {k: sample_launches[1][k] + n_gpu[k] + n_stepped[k] for k in n_gpu},
            "max_rel_err": max(worst.values()), "stepped_max_rel_err": max(worst2.values())}


def text_mask_path_phase(flash, card: str) -> dict:
    """`cli.sample.run` with `stage: mask` at full width and `selfattn`
    (embed 768): one case, 2 draws of 4 steps over a 512-token features file.
    flash_fwd launches per draw: 10 bf16 a step (5 ds-8 sites, attn1 and
    attn2) + 8 fp32 for the refinement (4 blocks, attn1 and attn2)."""
    import tempfile

    from jointimagegeneration_torch.cli.sample import run

    cfg = json.loads(json.dumps(TEXT_MASK_CFG))
    cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / "text_mask")
    s1 = cfg["stage1"]
    expected = cfg["samples"] * stage1_launches(s1, cfg["mask_steps"], TEXT_TOKENS)
    want_merges = cfg["samples"] * stage1_merges(flash, s1, TEXT_TOKENS)
    with tempfile.TemporaryDirectory() as tmp:
        cfg["text"] = {"features_npz": _text_features(Path(tmp) / "report.npz")}
        _reset_counts(flash)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run(cfg, device="cuda")
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _counts(flash)
    others = {k: v for k, v in launches.items() if k not in ("flash_fwd", "flash_fwd_merge")}
    check(launches["flash_fwd"] == expected and launches["flash_fwd_merge"] == want_merges
          and not any(others.values()),
          f"text mask path: launches {launches}, expected flash_fwd {expected}, flash_fwd_merge {want_merges}")
    labels, m = out["labels"], out["metrics"][0]
    check(labels.shape == (1, cfg["samples"], *s1["dataset"]["volume_shape"]), f"text mask path: labels {labels.shape}")
    check(int(labels.min()) >= 0 and int(labels.max()) < s1["num_classes"], "text mask path: labels out of range")
    check(math.isfinite(m["ged"]) and 0.0 <= m["hm_iou"] <= 1.0 and 0.0 <= m["dice"] <= 1.0,
          f"text mask path: metrics {m}")
    for name in ("pred.nii.gz", "pred.png", "gt.nii.gz"):
        check((Path(cfg["output_path"]) / "case_0000" / name).stat().st_size > 0, f"text mask path: {name}")
    n_steps = cfg["samples"] * cfg["mask_steps"]
    s_step = out["seconds"]["stage1"] / n_steps
    print(f"text mask path: stage: mask at 64x128x128 (base 64, bf16, selfattn embed 768, refiner 4 x 8 heads x 64 "
          f"over {TEXT_TOKENS} tokens), {cfg['samples']} draws x {cfg['mask_steps']} steps: {s_step:.4f} s/step "
          f"(incl. each draw's refinement), peak torch.cuda.max_memory_allocated {peak:.2f} GiB, run() wall "
          f"{wall:.2f} s; dice {m['dice']:.4f} GED {m['ged']:.4f} HM-IoU {m['hm_iou']:.4f}; flash_fwd launches "
          f"{launches['flash_fwd']} = {cfg['samples']} x ({cfg['mask_steps']} x 10 bf16 + 8 fp32 refiner), "
          f"flash_fwd_merge {launches['flash_fwd_merge']} (the refiner's); card {card}", flush=True)
    return {"launches": launches["flash_fwd"], "merges": launches["flash_fwd_merge"], "s_per_step": s_step,
            "peak_gib": peak, **m}


def text_two_stage_phase(flash, card: str, ddim_path: dict) -> dict:
    """`cli.sample.run` on TWO_STAGE_CFG with `selfattn` and the text: 4 mask
    steps, 2 slices in one chunk, DDIM-50.  The context goes to stage 1 only:
    stage 2's launches per UNet call are the untexted path's."""
    import tempfile

    cfg = json.loads(json.dumps(TEXT_TWO_STAGE_CFG))
    cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / "text_two_stage")
    with tempfile.TemporaryDirectory() as tmp:
        cfg["text"] = {"features_npz": _text_features(Path(tmp) / "report.npz")}
        out = sampling_run(flash, cfg, "text two-stage path", card, ctx_len=TEXT_TOKENS)
    text_s1 = stage1_launches(cfg["stage1"], cfg["mask_steps"], TEXT_TOKENS)
    s2_per_call = (out["launches"] - text_s1) / out["stage2_calls"]
    plain_s1 = stage1_launches(TWO_STAGE_CFG["stage1"], TWO_STAGE_CFG["mask_steps"])
    base = (ddim_path["launches"] - plain_s1) / ddim_path["stage2_calls"]
    check(s2_per_call == base, f"text two-stage path: stage 2 launched {s2_per_call} a call, the untexted {base}")
    return out


def ldm_train_path_phase(flash, card: str) -> dict:
    """Stage-2 training at full width through `cli.train_ldm.run`, then a
    resumed run; returns the first run's launch counts and numbers.  The
    checkpoints (params, EMA and AdamW's two moments in fp32: ~2.8 GB each)
    are deleted at the end."""
    from jointimagegeneration_torch.cli.sample import build_slice_ldm
    from jointimagegeneration_torch.cli.train_ldm import run
    from jointimagegeneration_torch.core.checkpoint import CheckpointManager

    cfg = json.loads(json.dumps(STAGE2_TRAIN_CFG))
    out_dir = ROOT / "build" / "chip_smoke" / "train_ldm"
    cfg["output_path"] = str(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    logdir = out_dir / "smoke"
    sites = flash_sites(cfg["dataset"]["slice_shape"], cfg["model"]["unet_config"]["params"], "channel_mult")
    n_steps, n_eval = cfg["max_steps"], cfg["max_steps"] // cfg["eval_every"]
    # a validation: the panels' three DDIM chains (samples, inpaint, outpaint)
    # of log_ddim_steps (20, at most T/2) forwards each, then one forward of
    # its batch for val/loss_simple
    panel_calls = 3 * min(cfg.get("log_ddim_steps", 20), cfg["model"]["timesteps"] // 2)
    expected = {"flash_fwd": sites * (n_steps + n_eval * (1 + panel_calls)), "flash_fwd_merge": 0,
                "flash_bwd_dkv": sites * n_steps,
                "flash_bwd_dq": sites * n_steps, "flash_bwd_reduce": 0,  # bf16: no split reduce
                "conv3d": 0, "conv3d_splitk_reduce": 0, "conv3d_stats_reduce": 0}  # a 2D UNet
    try:
        torch.cuda.reset_peak_memory_stats()
        state, launches, wall, _ = _train_run(flash, run, cfg, "smoke")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(launches == expected, f"ldm train path: launches {launches}, expected {expected}")
        recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in recs if "train/loss" in r]
        check([r["step"] for r in train] == list(range(1, n_steps + 1)), f"ldm train path: logged steps {train}")
        check(all(math.isfinite(r["train/loss"]) for r in train), "ldm train path: a logged loss is not finite")
        check(all(r["train/grad_finite"] == 1.0 and r["train/nonfinite_skipped"] == 0.0 for r in train),
              "ldm train path: a step had non-finite gradients")
        val = [(r["step"], r["val/loss_simple"]) for r in recs if "val/loss_simple" in r]
        panel_s = [r["val/panel_seconds"] for r in recs if "val/panel_seconds" in r]
        check(len(val) == 1 and val[0][0] == n_steps and math.isfinite(val[0][1]) and val[0][1] > 0,
              f"ldm train path: val/loss_simple {val}")
        pngs = sorted(p.name for p in (logdir / "images").glob("*.png"))
        check(pngs == sorted(f"val_{n}_gs-{n_steps:06d}.png" for n in
                             ("inputs", "samples", "inpaint", "outpaint", "denoise_row", "overlay")),
              f"ldm train path: panels {pngs}")
        steps = CheckpointManager(logdir / "checkpoints").all_steps()
        check(steps["rolling"] == [3, 6] and steps["best"] == [6], f"ldm train path: checkpoints {steps}")
        ckpt_gb = (logdir / "checkpoints" / "6.pt").stat().st_size / 1e9
        fresh = build_slice_ldm(cfg["model"], "cuda", seed=cfg["seed"]).unet
        moved = [(p - p0).abs().max().item() > 0 for p, p0 in zip(state.params, fresh.parameters())]
        check(sum(moved) > 0.9 * len(moved), f"ldm train path: only {sum(moved)} of {len(moved)} params moved")
        ema_off = max((e - p).abs().max().item() for e, p in zip(state.ema, state.params))
        check(ema_off > 0, "ldm train path: the EMA equals the params")
        n_params = sum(p.numel() for p in state.params)
        sec = sorted(r["train/step_seconds"] for r in train[1:])  # step 1 carries cuDNN's first-call setup
        s_per_step = sec[len(sec) // 2]
        print(f"ldm train path: stage 2 (512x512, base 128, {n_params / 1e6:.1f}M params, bf16, AdamW + EMA) "
              f"{n_steps} steps, warmed {s_per_step:.4f} s/step (median of steps 2-{n_steps}; step 1 "
              f"{train[0]['train/step_seconds']:.3f} s), losses {[round(r['train/loss'], 4) for r in train]}, "
              f"val/loss_simple {val[0][1]:.4f}, {len(pngs)} panel PNGs in {panel_s[0]:.3f} s "
              f"({panel_s[0] / panel_calls:.4f} s per b = 2 forward), peak torch.cuda.max_memory_allocated "
              f"{peak_gib:.2f} GiB, checkpoint {ckpt_gb:.2f} GB, run() wall {wall:.2f} s (incl. model init, data, "
              f"validation with its {panel_calls} panel forwards and three checkpoint writes); launches {launches} "
              f"= expected; card {card}", flush=True)
        del state, fresh
        gc.collect()
        torch.cuda.empty_cache()

        cfg2 = dict(cfg, resume=True, max_steps=n_steps + 2)
        expected2 = {k: sites * 2 if k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq") else 0 for k in expected}
        state2, launches2, wall2, printed = _train_run(flash, run, cfg2, "smoke")
        check(f"resumed from step {n_steps}" in printed, "ldm train path: the rerun did not resume from step 6")
        check(state2.step == n_steps + 2, f"ldm train path: resumed run ended at step {state2.step}")
        check(launches2 == expected2, f"ldm train path (resumed): launches {launches2}, expected {expected2}")
        print(f"ldm train path: resumed from step {n_steps} to {state2.step} in {wall2:.2f} s; launches "
              f"{launches2} = expected", flush=True)
        del state2
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": launches, "launches_resumed": launches2, "s_per_step": s_per_step, "peak_gib": peak_gib,
            "run_wall_s": wall, "val_loss_simple": val[0][1], "panel_seconds": panel_s[0], "checkpoint_gb": ckpt_gb}


def write_real_fixture(root: Path) -> dict:
    """The real data phase's fixture under `root`, written with the port's
    NIfTI writer: per case `cases/<case>/{image,totalseg,crcseg}.nii.gz` and
    `features.npz`, the index from `cli.build_index` (+ each case's
    "text_features"), and the nnUNet tree (`imagesTr/<case>_0000.nii.gz` a
    hard link of the CT, `labelsTr/<case>.nii.gz` the class ids).  The
    labels: ellipsoid organs at a quarter of the size, repeated 4x along
    each axis; classes 1..10 as their TotalSegmentator ids, class 11 as colon
    with the crcseg mask, the body's background as ids that map to 0."""
    from jointimagegeneration_torch.cli import build_index
    from jointimagegeneration_torch.data.classes import remap_totalseg_labels
    from jointimagegeneration_torch.data.datasets import synthesize_case
    from jointimagegeneration_torch.data.nifti import write_nifti

    shutil.rmtree(root, ignore_errors=True)
    tree, nnunet = root / "cases", root / "nnunet"
    for sub in ("imagesTr", "labelsTr"):
        (nnunet / sub).mkdir(parents=True)
    t0 = time.perf_counter()
    ids = np.array((0,) + TOTALSEG_IDS + (57,), np.uint8)  # class -> TotalSegmentator id (tumour in the colon)
    hu = np.array([20, 45, 30, 30, 60, 35, 40, 25, 30, 10, 5, 50], np.float32)  # soft tissue, organs, tumour
    gen = np.random.default_rng(2024)
    z, y, x = np.ogrid[:REAL_SHAPE[0], :REAL_SHAPE[1], :REAL_SHAPE[2]]
    h, w = REAL_SHAPE[1:]
    body = ((y - h / 2) / (0.45 * h)) ** 2 + ((x - w / 2) / (0.39 * w)) ** 2 <= 1.0
    texts = {}
    for c in range(3):
        name = f"case_{c:02d}"
        labels = synthesize_case(gen, tuple(s // 4 for s in REAL_SHAPE), 12)
        labels = labels.repeat(4, 0).repeat(4, 1).repeat(4, 2)
        seg = ids[labels]
        background = (labels == 0) & body
        seg[background & (z % 2 == 0)], seg[background & (z % 2 == 1)] = BACKGROUND_IDS
        tumor = (labels == 11).astype(np.uint8)
        check(set(np.unique(seg)) == {0, *TOTALSEG_IDS, *BACKGROUND_IDS}, f"fixture {name}: ids {np.unique(seg)}")
        image = np.where(body, hu[labels], -1000.0) + 15.0 * gen.standard_normal(REAL_SHAPE, dtype=np.float32)
        d = tree / name
        d.mkdir(parents=True)
        write_nifti(d / "image.nii.gz", image.astype(np.int16), spacing=(0.8, 0.8, 2.5))
        write_nifti(d / "totalseg.nii.gz", seg, spacing=(0.8, 0.8, 2.5))
        write_nifti(d / "crcseg.nii.gz", tumor, spacing=(0.8, 0.8, 2.5))
        np.savez(d / "features.npz", features=gen.standard_normal((REAL_TOKENS, TEXT_FCE["embed_dim"]),
                                                                  dtype=np.float32))
        texts[name] = f"CT abdomen, case {c}: colorectal mass."
        os.link(d / "image.nii.gz", nnunet / "imagesTr" / f"{name}_0000.nii.gz")
        write_nifti(nnunet / "labelsTr" / f"{name}.nii.gz", remap_totalseg_labels(seg, tumor).astype(np.uint8))
    (root / "texts.json").write_text(json.dumps(texts))
    with contextlib.redirect_stdout(io.StringIO()):
        index = build_index.main([str(tree), str(root / "index.json"), "--texts", str(root / "texts.json")])
    for name, entry in index.items():
        check(set(entry) == {"image", "totalseg", "crcseg", "text"} and not Path(entry["image"]).is_absolute(),
              f"build_index: {name} {entry}")
        entry["text_features"] = f"cases/{name}/features.npz"
    (root / "index.json").write_text(json.dumps(index, indent=1))
    nbytes = sum(p.stat().st_size for p in root.rglob("*.nii.gz"))
    return {"index": str(root / "index.json"), "nnunet": str(nnunet), "seconds": time.perf_counter() - t0,
            "gb": nbytes / 1e9}


def _seconds(fn, *args):
    """(fn(*args), the lesser wall seconds of two calls)."""
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append(time.perf_counter() - t0)
    return out, min(times)


def real_item_seconds(fixture: dict, card: str) -> dict:
    """Host seconds of one train item of each dataset kind, and of its parts
    (decode: read_nifti of its files; remap; resize or window + crop), each
    the lesser of two calls."""
    from jointimagegeneration_torch.data import datasets as D
    from jointimagegeneration_torch.data.classes import remap_totalseg_labels
    from jointimagegeneration_torch.data.nifti import read_nifti
    from jointimagegeneration_torch.data.transforms import crop_or_pad, resize_volume, window_norm

    index = fixture["index"]
    vshape = tuple(REAL_STAGE1["dataset"]["volume_shape"])
    kinds = {"ruijin": D.RuijinMaskDataset(index, volume_shape=vshape),
             "ruijin_3d": D.RuijinVolumeDataset(index, volume_shape=vshape),
             "ruijin_slices": D.RuijinSlicePairDataset(index, slice_shape=REAL_STAGE2["dataset"]["slice_shape"]),
             "nnunet": D.NNUNetLayoutDataset(fixture["nnunet"], slice_shape=REAL_STAGE2["dataset"]["slice_shape"])}
    ds = kinds["ruijin_slices"]
    case = ds.index[ds.keys[0]]
    (seg, _), t_seg = _seconds(read_nifti, ds._resolve(case["totalseg"]))
    (tumor, _), t_tumor = _seconds(read_nifti, ds._resolve(case["crcseg"]))
    (img, _), t_img = _seconds(read_nifti, ds._resolve(case["image"]))
    labels, t_remap = _seconds(remap_totalseg_labels, seg, tumor)
    _, t_nearest = _seconds(resize_volume, labels, vshape, "nearest")
    win, t_window = _seconds(window_norm, img)
    _, t_linear = _seconds(resize_volume, win, vshape, "linear")
    _, t_crop = _seconds(crop_or_pad, win, (win.shape[0], *REAL_STAGE2["dataset"]["slice_shape"]))
    parts = {"ruijin": {"decode_s": t_seg + t_tumor, "remap_s": t_remap, "resize_s": t_nearest},
             "ruijin_3d": {"decode_s": t_seg + t_tumor + t_img, "remap_s": t_remap,
                           "resize_s": t_window + t_linear + t_nearest},
             "ruijin_slices": {"decode_s": t_seg + t_tumor + t_img, "remap_s": t_remap, "crop_s": t_window + t_crop},
             "nnunet": {"decode_s": t_img + t_seg, "crop_s": t_window + t_crop}}
    for kind, dset in kinds.items():
        parts[kind]["item_s"] = _seconds(dset.__getitem__, 0)[1]
    print("real data: host seconds per train item (one thread calling): " + "; ".join(
        f"{k} {v['item_s']:.3f} s ({', '.join(f'{p[:-2]} {t:.3f}' for p, t in v.items() if p != 'item_s')})"
        for k, v in parts.items()) + f"; card {card}", flush=True)
    for kind in ("ruijin", "ruijin_slices"):  # what each trainer's loader keeps up with: 2 threads, to the card
        parts[kind]["loader_s_per_item"] = loader_seconds_per_item(kinds[kind])
    print(f"real data: the trainers' DataLoader (2 threads, batch 1, to the card) over 8 items: "
          f"{parts['ruijin']['loader_s_per_item']:.3f} s/item (ruijin), "
          f"{parts['ruijin_slices']['loader_s_per_item']:.3f} s/item (ruijin slices); card {card}", flush=True)
    return parts


class _Repeated:
    """`n` items cycling over a dataset's."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return self.dataset[i % len(self.dataset)]


def loader_seconds_per_item(dataset, n: int = 8) -> float:
    """Wall seconds per item of one pass of `data.loader.DataLoader` (2 worker
    threads, batch 1, to the card) over `n` items of `dataset`."""
    from jointimagegeneration_torch.data.loader import DataLoader

    loader = DataLoader(_Repeated(dataset, n), 1, device="cuda", num_workers=2)
    t0 = time.perf_counter()
    for _ in loader:
        pass
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def _train_records(logdir: Path, label: str, n_steps: int) -> list:
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    check([r["step"] for r in train] == list(range(1, n_steps + 1)), f"{label}: logged steps {train}")
    check(all(math.isfinite(r["train/loss"]) and r["train/grad_finite"] == 1.0 for r in train),
          f"{label}: a loss or a gradient is not finite: {train}")
    return recs


def _real_train(flash, run, cfg: dict, label: str, expected: dict) -> dict:
    """One trainer run on the real data with its launches checked; returns
    its metrics records, s/step, the loader wait and the peak GiB."""
    torch.cuda.reset_peak_memory_stats()
    state, launches, wall, _ = _train_run(flash, run, cfg, "smoke")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == expected, f"{label}: launches {launches}, expected {expected}")
    check(state.step == cfg["max_steps"], f"{label}: ended at step {state.step}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    recs = _train_records(Path(cfg["output_path"]) / "smoke", label, cfg["max_steps"])
    train = [r for r in recs if "train/loss" in r]
    return {"recs": recs, "launches": launches, "wall_s": wall, "peak_gib": peak,
            "step_s": [r["train/step_seconds"] for r in train], "data_s": [r["train/data_seconds"] for r in train]}


def _train_text(label: str, out: dict, what: str, card: str) -> None:
    print(f"{label}: {what}, {len(out['step_s'])} steps: s/step {[round(t, 4) for t in out['step_s']]} (step 1 "
          f"carries cuDNN's first-call setup), waited on the loader {[round(t, 4) for t in out['data_s']]} s "
          f"before each step, peak torch.cuda.max_memory_allocated {out['peak_gib']:.2f} GiB, run() wall "
          f"{out['wall_s']:.2f} s; launches {out['launches']} = expected; card {card}", flush=True)


def real_data_phase(flash, card: str) -> dict:
    """Both trainers on an index of CT volumes at full width, and the sampler
    on the checkpoints they write (see REAL_SHAPE): stage 1 with `selfattn`
    on the cases' 128-token features (launches stage1_launches(cfg, 1, 128)
    a step, the refiner plain, plus the validation's), `stage: mask` from
    its `checkpoints/` on the val case (equal, bit for bit, to the same draws
    with the checkpoint's EMA weights loaded by hand), stage 2 on `ruijin`
    with a validation, `stage: ct` from its `checkpoints/` (2 slices of
    DDIM-50, LPIPS against the case's CT), and stage 2 on `nnunet`.  Every
    file it writes (the ~2.8 GB stage-2 checkpoints too) is deleted at the
    end."""
    from jointimagegeneration_torch.cli import sample, train_ldm, train_mask
    from jointimagegeneration_torch.core.checkpoint import CheckpointManager
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    root = ROOT / "build" / "chip_smoke" / "real"
    zero = {"flash_fwd_merge": 0, "flash_bwd_reduce": 0, "conv3d": 0, "conv3d_splitk_reduce": 0,
            "conv3d_stats_reduce": 0}
    out = {}
    try:
        fixture = write_real_fixture(root)
        print(f"real data: 3 cases of {REAL_SHAPE} int16 HU + uint8 totalseg + crcseg ({fixture['gb']:.2f} GB of "
              f".nii.gz, the nnUNet tree's labels included) written in {fixture['seconds']:.2f} s", flush=True)
        out["item_seconds"] = real_item_seconds(fixture, card)

        # stage 1, text-guided, on the index
        cfg = json.loads(json.dumps(REAL_STAGE1))
        cfg["dataset"]["index"], cfg["output_path"] = fixture["index"], str(root / "stage1")
        per_step = stage1_launches(cfg, 1, REAL_TOKENS)  # 5 sites, attn1 + attn2; the 128-token refiner is plain
        val_launches = stage1_launches(cfg, cfg["eval_time_steps"], REAL_TOKENS)
        s1 = _real_train(flash, train_mask.run, cfg, "real stage 1",
                         {"flash_fwd": 2 * per_step + val_launches, "flash_bwd_dkv": 2 * per_step,
                          "flash_bwd_dq": 2 * per_step, **zero})
        dice = [r["val/dice"] for r in s1["recs"] if "val/dice" in r]
        check(len(dice) == 1 and 0.0 <= dice[0] <= 1.0, f"real stage 1: val/dice {dice}")
        ckdir = Path(cfg["output_path"]) / "smoke" / "checkpoints"
        steps = CheckpointManager(ckdir).all_steps()
        check(steps["rolling"] == [2] and steps["best"] == [2], f"real stage 1: checkpoints {steps}")
        _train_text("real stage 1", s1, f"64x128x128, base 64, bf16, selfattn over {REAL_TOKENS}-token features, "
                    f"AdamW + EMA, val/dice {dice[0]:.4f} on the val case", card)
        out["stage1"] = {k: v for k, v in s1.items() if k != "recs"} | {"val_dice": dice[0]}

        # stage: mask from the stage-1 checkpoints, on the val split
        s1_section = {k: v for k, v in cfg.items() if k not in ("output_path",)}
        val_case = sample.build_mask_dataset(s1_section, "val")
        feats = str(Path(fixture["index"]).parent / val_case.index[val_case.keys[0]]["text_features"])
        scfg = {"stage": "mask", "seed": 1024, "n_cases": 1, "samples": 1, "mask_steps": 4, "split": "val",
                "output_path": str(root / "mask"), "text": {"features_npz": feats},
                "stage1": {**s1_section, "checkpoint": str(ckdir)}}
        expected = stage1_launches(s1_section, scfg["mask_steps"], REAL_TOKENS)
        _reset_counts(flash)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            res = sample.run(scfg, device="cuda")
        wall = time.perf_counter() - t0
        launches = _counts(flash)
        check(launches == {"flash_fwd": expected, "flash_bwd_dkv": 0, "flash_bwd_dq": 0, **zero},
              f"real mask sampling: launches {launches}, expected flash_fwd {expected}")
        check(f"EMA weights of {ckdir}" in printed.getvalue(), "real mask sampling: the checkpoint was not read")
        labels, m = res["labels"][0, 0], res["metrics"][0]
        check(labels.shape == tuple(cfg["dataset"]["volume_shape"]) and 0 <= labels.min() and labels.max() < 12,
              f"real mask sampling: labels {labels.shape} in [{labels.min()}, {labels.max()}]")
        check(0.0 <= m["dice"] <= 1.0, f"real mask sampling: dice {m}")
        ms = sample.build_mask_sampler(s1_section, "cuda")
        ema = torch.load(CheckpointManager(ckdir).step_path(), map_location="cpu", weights_only=True)["ema"]
        ms.unet.load_state_dict({k: v for k, v in ema.items() if not k.startswith("refiner.")})
        ms.refiner.load_state_dict({k[len("refiner."):]: v for k, v in ema.items() if k.startswith("refiner.")})
        item = val_case[0]
        with torch.inference_mode():
            ctx = torch.from_numpy(np.load(feats)["features"])[None].cuda()
            by_hand = ms.sample_labels(NoiseSource(scfg["seed"], "cuda"), (1, *cfg["dataset"]["volume_shape"]),
                                       cond=torch.from_numpy(item["image"])[None].cuda(), context=ctx,
                                       num_steps=scfg["mask_steps"])[0].cpu().numpy()
        check(np.array_equal(by_hand, labels), "real mask sampling: the labels differ from the same draws with "
              f"the EMA weights loaded by hand on {int((by_hand != labels).sum())} voxels")
        del ms, ema
        print(f"real mask sampling: stage: mask from {ckdir.relative_to(root)} (newest step's EMA weights) on the "
              f"val case {val_case.keys[0]}, {scfg['mask_steps']} steps: {res['seconds']['stage1']:.3f} s, run() "
              f"wall {wall:.2f} s; dice {m['dice']:.4f} against its mask; labels equal to the by-hand EMA load; "
              f"flash_fwd launches {expected} = expected; card {card}", flush=True)
        out["mask"] = {"launches": expected, "dice": m["dice"], "stage1_s": res["seconds"]["stage1"]}
        shutil.rmtree(Path(cfg["output_path"]), ignore_errors=True)

        # stage 2 on the index, then stage: ct from its checkpoints
        cfg2 = json.loads(json.dumps(REAL_STAGE2))
        cfg2["dataset"]["index"], cfg2["output_path"] = fixture["index"], str(root / "stage2")
        sites = flash_sites(cfg2["dataset"]["slice_shape"], cfg2["model"]["unet_config"]["params"], "channel_mult")
        panel_calls = 3 * min(cfg2.get("log_ddim_steps", 20), cfg2["model"]["timesteps"] // 2)
        s2 = _real_train(flash, train_ldm.run, cfg2, "real stage 2",
                         {"flash_fwd": sites * (2 + 1 + panel_calls), "flash_bwd_dkv": 2 * sites,
                          "flash_bwd_dq": 2 * sites, **zero})
        val = [r["val/loss_simple"] for r in s2["recs"] if "val/loss_simple" in r]
        check(len(val) == 1 and math.isfinite(val[0]) and val[0] > 0, f"real stage 2: val/loss_simple {val}")
        ckdir2 = Path(cfg2["output_path"]) / "smoke" / "checkpoints"
        steps = CheckpointManager(ckdir2).all_steps()
        check(steps["rolling"] == [2] and steps["best"] == [2], f"real stage 2: checkpoints {steps}")
        hw = cfg2["dataset"]["slice_shape"]
        _train_text("real stage 2", s2, f"ruijin {hw[0]}x{hw[1]}, base 128, bf16, AdamW + EMA, val/loss_simple {val[0]:.4f} "
                    f"(panels at b = 1 on the val case)", card)
        out["stage2"] = {k: v for k, v in s2.items() if k != "recs"} | {"val_loss_simple": val[0]}

        ccfg = {"stage": "ct", "seed": 1024, "n_cases": 1, "ddim_steps": 50, "slices": 2, "split": "val",
                "output_path": str(root / "ct"),
                "stage2": {**cfg2["model"], "slice_size": hw[0], "dataset": cfg2["dataset"], "checkpoint": str(ckdir2)}}
        expected = sites * ccfg["slices"] * ccfg["ddim_steps"]
        _reset_counts(flash)
        t0 = time.perf_counter()
        res = sample.run(ccfg, device="cuda")
        wall = time.perf_counter() - t0
        launches = _counts(flash)
        check(launches == {"flash_fwd": expected, "flash_bwd_dkv": 0, "flash_bwd_dq": 0, **zero},
              f"real ct sampling: launches {launches}, expected flash_fwd {expected}")
        ct, lp = res["ct"], (res["metrics"] or {}).get("lpips_three_view_mean")
        check(ct.shape == (1, 2, *hw) and bool(np.isfinite(ct).all()) and 0.0 <= ct.min() and ct.max() <= 1.0,
              f"real ct sampling: CT {ct.shape} in [{ct.min()}, {ct.max()}]")
        check(lp is not None and math.isfinite(lp), f"real ct sampling: LPIPS {res['metrics']}")
        print(f"real ct sampling: stage: ct from {ckdir2.relative_to(root)} on the val case, 2 slices x DDIM-50 at "
              f"{hw[0]}x{hw[1]}: {res['seconds']['stage2'] / 2:.4f} s/slice, run() wall {wall:.2f} s; LPIPS (3 views, "
              f"uncalibrated VGG) {lp:.4f} against the case's CT; flash_fwd launches {expected} = expected; card "
              f"{card}", flush=True)
        out["ct"] = {"launches": expected, "lpips_three_view": lp, "s_per_slice": res["seconds"]["stage2"] / 2}
        shutil.rmtree(Path(cfg2["output_path"]), ignore_errors=True)

        # stage 2 on the nnUNet tree
        cfg3 = {**cfg2, "dataset": {"kind": "nnunet", "root": fixture["nnunet"], "slice_shape": hw},
                "validate": False, "save_freq": 1000, "output_path": str(root / "nnunet_run")}
        s3 = _real_train(flash, train_ldm.run, cfg3, "nnunet stage 2",
                         {"flash_fwd": 2 * sites, "flash_bwd_dkv": 2 * sites, "flash_bwd_dq": 2 * sites, **zero})
        _train_text("nnunet stage 2", s3, f"nnUNet tree, {hw[0]}x{hw[1]}, base 128, bf16, AdamW + EMA, no validation",
                    card)
        out["nnunet"] = {k: v for k, v in s3.items() if k != "recs"}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a machine with an NVIDIA GPU",
              file=sys.stderr)
        return 1
    try:
        from jointimagegeneration_torch.ops import conv3d as conv
        from jointimagegeneration_torch.ops import flash_attention as flash
        from jointimagegeneration_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: the jointimagegeneration_torch package is not here ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build_s = build.build_all([flash.FLASH_SOURCE, flash.FLASH_BWD_SOURCE, conv.CONV3D_SOURCE])
    print(f"build: {build_s} ({time.perf_counter() - t0:.2f} s wall)", flush=True)

    rows, merge_rows = flash_phase(flash)
    bwd_rows = bwd_phase(flash)
    conv_rows, conv_edge = conv_phase(conv)
    reference_phase(flash)
    sampler_ref = sampler_reference_phase(flash)
    latent_ref = latent_reference_phase(flash)
    fused_ref = fused_reference_phase(flash)
    ddim_path = path_phase(flash, card)
    fast = fast_path_phase(flash, card, ddim_path)
    tiled = tiled_path_phase(flash, card)
    latent = latent_path_phase(flash, card)
    fused = fused_path_phase(flash, card)
    train_reference_phase(flash)
    train = train_path_phase(flash, card)
    text_ref = text_reference_phase(flash)
    text_mask = text_mask_path_phase(flash, card)
    text_two_stage = text_two_stage_phase(flash, card, ddim_path)
    text_train = train_path_phase(flash, card, TEXT_TRAIN_CFG, "text train path", "train_text")
    long_train = train_path_phase(flash, card, TEXT_LONG_TRAIN_CFG, "text long-report train path", "train_text_long",
                                  resume=False)
    print(f"text long-report train path: {long_train['s_per_step']:.4f} s/step, peak {long_train['peak_gib']:.2f} "
          f"GiB, the refiner's fp32 flash backward {long_train['f32_bwd_ms_per_step']:.4f} device ms per step "
          f"(8 dkv + 8 dq, {long_train['launches']['flash_bwd_reduce'] // TEXT_LONG_TRAIN_CFG['max_steps']} split "
          f"reduces); the 4-token text train path {text_train['s_per_step']:.4f} s/step, peak "
          f"{text_train['peak_gib']:.2f} GiB, no fp32 flash backward (its refiner attention is plain); card {card}",
          flush=True)
    ldm_train_reference_phase(flash)
    ldm_train = ldm_train_path_phase(flash, card)
    real = real_data_phase(flash, card)

    main_row = rows[1]  # (16, 1024, 32): the stage-2 site, most of the sampling path's launches
    fwd_launches = {"two_stage_sampling": ddim_path["launches"], "fast_sampling": fast["fast path"]["launches"],
                    "fast_sampling_variant": fast["fast path variant"]["launches"],
                    "tiled_sampling": tiled["launches"],
                    "sampler_reference": sum(r["launches"] for r in sampler_ref.values()),
                    "latent_reference": sum(r["launches"] for r in latent_ref.values()),
                    "latent_ct_sampling": latent["launches"],
                    "stage1_training": train["launches"]["flash_fwd"],
                    "stage2_training": ldm_train["launches"]["flash_fwd"],
                    "text_reference": text_ref["launches"]["flash_fwd"],
                    "text_mask_sampling": text_mask["launches"],
                    "text_two_stage_sampling": text_two_stage["launches"],
                    "stage1_text_training": text_train["launches"]["flash_fwd"],
                    "stage1_long_report_training": long_train["launches"]["flash_fwd"],
                    "real_stage1_text_training": real["stage1"]["launches"]["flash_fwd"],
                    "real_mask_sampling": real["mask"]["launches"],
                    "real_stage2_training": real["stage2"]["launches"]["flash_fwd"],
                    "real_ct_sampling": real["ct"]["launches"],
                    "nnunet_stage2_training": real["nnunet"]["launches"]["flash_fwd"]}
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "jointimagegeneration_torch/csrc/flash_fwd.cu",
        "replaces": "jointimagegeneration_tpu/ops/pallas/flash_attention.py:149",
        "launches": sum(fwd_launches.values()),
        "launches_by_path": fwd_launches,
        "max_abs_err": max(r["err_o"] for r in rows),
        "ms": main_row["ms"],
        "eager_ms": main_row["eager_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "tensor_bound_ms": main_row["tensor_bound_ms"],
        "exp_bound_ms": main_row["exp_bound_ms"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]
    # the fp32 forward's split merge, as the refiner's 640-token row runs it
    merge_launches = {"sampler_reference": sum(r["merges"] for r in sampler_ref.values()),
                      "latent_reference": sum(r.get("merges", 0) for r in latent_ref.values()),
                      "text_reference": text_ref["launches"]["flash_fwd_merge"],
                      "text_mask_sampling": text_mask["merges"],
                      "text_two_stage_sampling": text_two_stage["merges"],
                      "stage1_long_report_training": long_train["launches"]["flash_fwd_merge"]}
    merge_row = merge_rows[1]
    kernels.append({
        "name": "flash_fwd_merge",
        "route": "cuda",
        "source": "jointimagegeneration_torch/csrc/flash_fwd.cu",
        "replaces": "jointimagegeneration_tpu/ops/pallas/flash_attention.py:149",
        "note": ("flash_fwd_merge_f32_kernel: combines the fp32 forward's key-loop splits (m, l, O) in split order, "
                 "where the TPU kernel walks every key tile of a q block in one sequential grid; the numbers are the "
                 "(8, 640, 640, 64) fp32 row's, its bound O and LSE written once at HBM's rate"),
        "launches": sum(merge_launches.values()),
        "launches_by_path": merge_launches,
        **{k: merge_row[k] for k in ("max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "splits", "all_bytes_hbm_ms")},
        "shapes": merge_rows,
    })
    train_row = bwd_rows[0]  # (8, 2048, 32) bf16: the stage-1 training site
    for name, line, grads in (("flash_bwd_dkv", 250, ("dk", "dv")), ("flash_bwd_dq", 282, ("dq",))):
        part = name.rsplit("_", 1)[1]
        bwd_launches = {"stage1_training": train["launches"][name], "stage2_training": ldm_train["launches"][name],
                        "text_reference": text_ref["launches"][name],
                        "stage1_text_training": text_train["launches"][name],
                        "stage1_long_report_training": long_train["launches"][name],
                        "real_stage1_text_training": real["stage1"]["launches"][name],
                        "real_stage2_training": real["stage2"]["launches"][name],
                        "nnunet_stage2_training": real["nnunet"]["launches"][name]}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "jointimagegeneration_torch/csrc/flash_bwd.cu",
            "replaces": f"jointimagegeneration_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": sum(bwd_launches.values()),
            "launches_by_path": bwd_launches,
            "max_abs_err": max(r[f"err_{g}"] for r in bwd_rows for g in grads),
            "ms": train_row[f"{part}_ms"],
            "plain_ms": train_row["plain_ms"],  # the plain backward computes dq, dk and dv together
            "bound_ms": train_row[f"{part}_bound_ms"],
            "bound_by": train_row[f"{part}_bound_by"],
            "tensor_bound_ms": train_row[f"{part}_tensor_bound_ms"],
            "exp_bound_ms": train_row[f"{part}_exp_bound_ms"],
            "library_ms": train_row["library_ms"],  # SDPA's backward, all three gradients
            "shapes": bwd_rows,
        })
    # the fp32 kernels' split reduce, as the refiner's 640-token row's dkv runs it
    reduce_row = next(r for r in bwd_rows if r["shape"] == [8, LONG_TEXT_TOKENS, LONG_TEXT_TOKENS, 64])["reduce"]
    reduce_launches = {"text_reference": text_ref["launches"]["flash_bwd_reduce"],
                       "stage1_long_report_training": long_train["launches"]["flash_bwd_reduce"]}
    kernels.append({
        "name": "flash_bwd_reduce",
        "route": "cuda",
        "source": "jointimagegeneration_torch/csrc/flash_bwd.cu",
        "replaces": "jointimagegeneration_tpu/ops/pallas/flash_attention.py:250",
        "note": ("splits_reduce_f32_kernel: sums the fp32 dkv and dq kernels' split partials in split order, "
                 "where the TPU kernels accumulate over their sequential grid; the numbers are the (8, 640, 640, "
                 "64) fp32 row's dkv reduce, its bound the sum written once at HBM's rate"),
        "launches": sum(reduce_launches.values()),
        "launches_by_path": reduce_launches,
        **{k: reduce_row[k] for k in ("max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "splits", "all_bytes_hbm_ms")},
    })
    fused_rows = [r for r in conv_rows + conv_edge if "activate" not in r["options"] and r["options"]]
    bare_rows = [r for r in conv_rows + conv_edge if "activate" in r["options"] or not r["options"]]
    fused_launches = {f"fused_{m}_sampling": fused[m]["launches"]["conv3d"] for m in ("kernel", "xla")}
    fused_launches["fused_kernel_fp32_sampling"] = fused["kernel fp32"]["launches"]["conv3d"]
    pallas_launches = {"pallas_conv_sampling": fused["pallas_conv"]["launches"]["conv3d"]}
    for name, line, row, launches, errs in (
            ("conv3d_fused_resblock", "fused_resblock.py:51", conv_rows[0], fused_launches, fused_rows),
            ("conv3d_3x3", "conv3d.py:52", conv_rows[5], pallas_launches, bare_rows),
            ("conv3d_3x3_v2", "conv3d.py:163", conv_rows[4], pallas_launches, bare_rows)):
        entry = {
            "name": name,
            "route": "cuda",
            "source": "jointimagegeneration_torch/csrc/conv3d.cu",
            "replaces": f"jointimagegeneration_tpu/ops/pallas/{line}",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["err"] for r in errs),
            **{k: row[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        if name == "conv3d_fused_resblock":
            for key in ("stats_reduce", "splitk_reduce"):
                entry[f"{key}_launches"] = sum(fused[m]["launches"][f"conv3d_{key}"]
                                               for m in ("kernel", "xla", "kernel fp32"))
            entry["fp32"] = {k: next(r for r in conv_rows if r["dtype"] == "float32")[k]
                             for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            entry["shapes"] = conv_rows
        if name == "conv3d_3x3":
            entry["fp32"] = {k: next(r for r in conv_rows if r["dtype"] == "float32" and r["options"] == "activate")[k]
                             for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            entry["note"] = ("no model path calls conv3d_3x3 itself (nor does the JAX package's); it is "
                             "the same function, entry point and kernel as conv3d_3x3_v2, whose launches "
                             "on the pallas_conv path these are")
        kernels.append(entry)
    print(f"sampling: {json.dumps({'reference': sampler_ref, 'ddim_path': ddim_path, **fast, 'tiled': tiled})}")
    print(f"latent: {json.dumps({'reference': latent_ref, 'path': latent})}")
    print(f"fused: {json.dumps({'reference': fused_ref, 'paths': fused})}")
    print(f"train: {json.dumps(train)}")
    print(f"ldm train: {json.dumps(ldm_train)}")
    text = {"reference": text_ref, "mask_path": text_mask, "two_stage_path": text_two_stage, "train_path": text_train,
            "long_report_train_path": long_train}
    print(f"text: {json.dumps(text)}")
    print(f"real: {json.dumps(real)}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
