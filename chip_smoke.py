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
     and wide-head shapes off the main paths.  The flash forward, then the
     flash backward (dkv and dq kernels) at the training shapes, then the
     3x3x3 conv kernel (`conv3d ...` lines: error, a bitwise repeat, the
     launch plan taken) at the fused and pallas_conv paths' shapes (library:
     F.conv3d), then checked at every distinct conv of the fused path and at
     its edge shapes;
  3. reference: a tiny two-stage pipeline on the card against the same
     pipeline on the CPU (same weights, same noise);
  4. fused reference: tiny fp32 fused MaskSamplers ('kernel' and 'xla') and
     one fp32 fused ResBlock's forward and backward on the card against the
     CPU (`fused reference ...` lines);
  5. path: `cli.sample.run` on `configs/sample_two_stage.yml`'s full widths
     (stage 1 64x128x128 at base 64, stage 2 256x256 at base 128, bf16), with
     only the lengths cut: 4 mask steps, the full 128x256x256 handoff, and two
     chunks of 2 slices with the full DDIM-50 chain;
  6. fused path: the same stage-1 sampler built with
     use_fused_resblock='kernel', 'xla' and use_pallas_conv=True, 4 steps
     each beside the unfused model, same weights and draws: s/step, launch
     counts (per step fused: 54 conv, 27 stats-reduce and a split-K reduce
     for each conv the launch planner splits; 8 conv under pallas_conv) and
     probabilities against an fp32 forward (`fused path ...`);
  7. train reference: three fp32 stage-1 train steps of a small UNet (T = 512
     at its attention sites, so the card runs the kernels) on the card against
     the same steps on the CPU: loss, every gradient and the params after
     each step;
  8. train path: `cli.train_mask.run` on `configs/stage1_mask.yml`'s full
     widths (64x128x128, 12 classes, base 64, bf16, AdamW, EMA), with only the
     lengths cut: 6 steps with checkpoints at 3 and 6 and one validation at 6,
     then a resumed run to step 8.
Before each main path (5, 6 per variant, 8) every kernel launch counter is set
to 0; after it the counts must equal what the path implies.  The last lines
are the fused and train summaries, a JSON line with the kernel numbers, the
card's name and power limit, and `{"ok": true, "device": {...}}`.  Imports neither JAX nor PyYAML.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
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
# the small UNet of the train reference phase: at base <= 32 every GroupNorm
# group holds one channel, and the bias added before such a norm has a
# gradient of exactly zero, whose rounding noise has no relative error to hold
TRAIN_REF_UNET = {"base_channels": 64, "channel_mult": [1, 2], "attention_resolutions": [1],
                  "num_res_blocks": 1, "num_head_channels": 16}
TRAIN_REF_TOL = 1e-4  # card vs CPU, fp32: of each tensor's max |CPU value|


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


def compare(flash, q, k, v, label: str) -> tuple:
    """Max abs error of the kernel against its plain version on the same
    inputs, (O, LSE); fails past the stated tolerances."""
    o, lse = flash.flash_forward(q, k, v)
    torch.cuda.synchronize()
    po, plse = flash.flash_attention_plain(q, k, v)
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    tol_o = O_REL_TOL[q.dtype] * po.float().abs().max().item()
    check(err_o <= tol_o and err_lse <= LSE_TOL,
          f"flash_fwd disagrees at {label}: O {err_o} (tol {tol_o}), LSE {err_lse} (tol {LSE_TOL})")
    return err_o, err_lse, tol_o


def flash_phase(flash) -> list:
    """The flash kernel at the main path's shapes: error, times, bound."""
    import torch.nn.functional as F

    shapes = [  # (BH, T, D), dtype, where the main path runs it
        ((8, 2048, 32), torch.bfloat16, "stage 1 ds8, 64x128x128"),
        ((16, 1024, 32), torch.bfloat16, "stage 2 ds8, 256x256"),
        ((16, 4096, 32), torch.bfloat16, "stage 2 ds8, 512x512"),
        ((8, 2048, 32), torch.float32, "fp32 torso"),
    ]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    rows = []
    for (bh, t, d), dtype, where in shapes:
        q = (torch.randn(bh, t, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
        k = torch.randn(bh, t, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, t, d, generator=g, device="cuda").to(dtype)
        dname = str(dtype).replace("torch.", "")
        err_o, err_lse, tol_o = compare(flash, q, k, v, f"{(bh, t, d)} {dname}")
        ms, eager_ms = time_ms(lambda: flash.flash_forward(q, k, v), 50)
        plain_ms, _ = time_ms(lambda: flash.flash_attention_plain(q, k, v), 10)
        q4, k4, v4 = q[None], k[None], v[None]
        library_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), 50)
        flops = 4.0 * bh * t * t * d
        nbytes = 4 * bh * t * d * q.element_size() + bh * t * 4
        bound_ms = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
        row = {"shape": [bh, t, t, d], "dtype": dname, "where": where,
               "err_o": err_o, "tol_o": tol_o, "err_lse": err_lse, "ms": ms, "eager_ms": eager_ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if flops / PEAK_FLOPS[dtype] >= nbytes / PEAK_BYTES else "bytes"}
        print(f"flash_fwd {row['shape']} {dname} ({where}): err O {err_o:.3g} (tol {tol_o:.3g}) "
              f"LSE {err_lse:.3g}; graph-timed kernel {ms:.4f} ms (eager {eager_ms:.4f}), "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({row['bound_by']}), {100 * bound_ms / ms:.1f}% of bound", flush=True)
        rows.append(row)
    # correctness only: shapes the eligibility rule admits off the main path
    # (ragged T, Tq != Tk, D padded up to the kernel's head width)
    for (bh, tq, tk, d), dtype in [((3, 100, 77, 40), torch.bfloat16), ((2, 130, 200, 256), torch.bfloat16),
                                   ((2, 1088, 1088, 16), torch.bfloat16), ((3, 100, 77, 40), torch.float32),
                                   ((2, 130, 70, 256), torch.float32), ((1, 7, 3, 5), torch.float32)]:
        q = (torch.randn(bh, tq, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
        k = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
        v = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
        dname = str(dtype).replace("torch.", "")
        err_o, err_lse, tol_o = compare(flash, q, k, v, f"{(bh, tq, tk, d)} {dname}")
        print(f"flash_fwd {[bh, tq, tk, d]} {dname} (edge shape): "
              f"err O {err_o:.3g} (tol {tol_o:.3g}) LSE {err_lse:.3g}", flush=True)
    return rows


def _attention_inputs(g, bh, tq, tk, d, dtype):
    """q (pre-scaled: unit-variance logits), k, v and dO ~ N(0, 1) in `dtype`."""
    q = (torch.randn(bh, tq, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
    k = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(bh, tq, d, generator=g, device="cuda").to(dtype)
    return q, k, v, do


def compare_bwd(flash, q, k, v, o, lse, do, label: str) -> dict:
    """Max abs error of dQ, dK, dV from the kernels against the plain version
    on the same inputs; fails past BWD_REL_TOL of each gradient's max |plain|."""
    got = flash.flash_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = flash.flash_backward_plain(q, k, v, o, lse, do)
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(a).all()), f"flash backward {name} not finite at {label}")
        err = (a.float() - b.float()).abs().max().item()
        tol = BWD_REL_TOL[q.dtype] * b.float().abs().max().item()
        check(err <= tol, f"flash backward {name} disagrees at {label}: {err} (tol {tol})")
        out[f"err_{name}"], out[f"tol_{name}"] = err, tol
    return out


def bwd_phase(flash) -> list:
    """The backward kernels at the training shapes: error, times, bounds.

    Per shape: `dkv_ms` / `dq_ms` are each kernel alone, `ms` the whole
    backward (delta + both kernels, as `flash_backward` runs it), all
    graph-timed; `library_ms` is the backward of
    `F.scaled_dot_product_attention` on the same inputs, timed as its
    forward + backward in one captured graph less its forward alone (the port
    never calls it).  Bounds: the whole backward does 5 products (S, dP, dV,
    dK, dQ: 10*BH*T^2*D flops) and moves q, k, v, O, dO in, dQ, dK, dV out
    and LSE, delta; dkv alone needs S, dP, dV, dK (8*BH*T^2*D) and dq alone
    S, dP, dQ (6*BH*T^2*D), each with its own inputs and outputs."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rows = []
    for (bh, t, d), dtype, where in BWD_SHAPES:
        q, k, v, do = _attention_inputs(g, bh, t, t, d, dtype)
        o, lse = flash.flash_forward(q, k, v)
        dname = str(dtype).replace("torch.", "")
        errs = compare_bwd(flash, q, k, v, o, lse, do, f"{(bh, t, d)} {dname}")
        delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
        ms, eager_ms = time_ms(lambda: flash.flash_backward(q, k, v, o, lse, do), 20)
        dkv_ms, _ = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta), 20)
        dq_ms, _ = time_ms(lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta), 20)
        plain_ms, _ = time_ms(lambda: flash.flash_backward_plain(q, k, v, o, lse, do), 5)
        q4, k4, v4, do4 = (x[None].detach().requires_grad_() for x in (q, k, v, do))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
            return torch.autograd.grad(out, (q4, k4, v4), do4)

        lib_fwd_ms, _ = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), 20)
        lib_both_ms, _ = time_ms(sdpa_fwd_bwd, 20)
        es, flops_unit = q.element_size(), 2.0 * bh * t * t * d
        io = bh * t * d * es

        def bound(flops, nbytes):
            f_ms, b_ms = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
            return max(f_ms, b_ms), "operations" if f_ms >= b_ms else "bytes"

        bound_ms, bound_by = bound(5 * flops_unit, 8 * io + 2 * bh * t * 4)
        dkv_bound, dkv_by = bound(4 * flops_unit, 6 * io + 2 * bh * t * 4)
        dq_bound, dq_by = bound(3 * flops_unit, 5 * io + 2 * bh * t * 4)
        row = {"shape": [bh, t, t, d], "dtype": dname, "where": where, **errs,
               "ms": ms, "eager_ms": eager_ms, "dkv_ms": dkv_ms, "dq_ms": dq_ms, "plain_ms": plain_ms,
               "library_ms": lib_both_ms - lib_fwd_ms, "library_fwd_bwd_ms": lib_both_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "dkv_bound_ms": dkv_bound,
               "dkv_bound_by": dkv_by, "dq_bound_ms": dq_bound, "dq_bound_by": dq_by}
        print(f"flash_bwd {row['shape']} {dname} ({where}): err dQ {errs['err_dq']:.3g} "
              f"(tol {errs['tol_dq']:.3g}) dK {errs['err_dk']:.3g} (tol {errs['tol_dk']:.3g}) "
              f"dV {errs['err_dv']:.3g} (tol {errs['tol_dv']:.3g}); graph-timed backward {ms:.4f} ms "
              f"(eager {eager_ms:.4f}) = dkv {dkv_ms:.4f} + dq {dq_ms:.4f} + delta; plain "
              f"{plain_ms:.4f} ms; sdpa backward {row['library_ms']:.4f} ms (fwd+bwd {lib_both_ms:.4f}); "
              f"bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of bound; "
              f"dkv bound {dkv_bound:.4f} ({dkv_by}), dq bound {dq_bound:.4f} ({dq_by})", flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, delta, q4, k4, v4, do4
        torch.cuda.empty_cache()
    # correctness only: the forward's edge shapes (ragged T, Tq != Tk, D padded)
    for (bh, tq, tk, d), dtype in [((3, 100, 77, 40), torch.bfloat16), ((2, 130, 200, 256), torch.bfloat16),
                                   ((2, 1088, 1088, 16), torch.bfloat16), ((1, 64, 64, 128), torch.bfloat16),
                                   ((3, 100, 77, 40), torch.float32), ((2, 130, 70, 256), torch.float32),
                                   ((1, 7, 3, 5), torch.float32), ((2, 600, 600, 64), torch.float32)]:
        q, k, v, do = _attention_inputs(g, bh, tq, tk, d, dtype)
        o, lse = flash.flash_forward(q, k, v)
        dname = str(dtype).replace("torch.", "")
        errs = compare_bwd(flash, q, k, v, o, lse, do, f"{(bh, tq, tk, d)} {dname}")
        print(f"flash_bwd {[bh, tq, tk, d]} {dname} (edge shape): " +
              " ".join(f"{n} {errs['err_' + n]:.3g} (tol {errs['tol_' + n]:.3g})" for n in ("dq", "dk", "dv")),
              flush=True)
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
    ((1, 32, 64, 64, 128), 128, "affine bias stats", torch.float32, "L1 fp32 torso, mode A"),
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


def planned_launches(conv, calls) -> dict:
    """Kernel launches of bf16 conv calls, by counter, from the launch planner."""
    total = {"conv3d": 0, "conv3d_splitk_reduce": 0, "conv3d_stats_reduce": 0}
    for shape, cout, opts in calls:
        for k, v in conv.plan_conv3d(*shape, cout, torch.bfloat16, conv_flags(opts)).launches.items():
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
    checks = [(shape, cout, opts, torch.bfloat16, "fused path") for shape, cout, opts in fused]
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

    def gumbel(self, shape):
        return self.src.gumbel(shape).to(self.device)


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


def path_phase(flash, card: str) -> int:
    from jointimagegeneration_torch.cli.sample import run

    cfg = json.loads(json.dumps(TWO_STAGE_CFG))
    cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / "samples")
    s1, s2 = cfg["stage1"], cfg["stage2"]
    u2 = s2["unet_config"]["params"]
    expected = (cfg["mask_steps"] * flash_sites(s1["dataset"]["volume_shape"], s1["unet_openai"], "channel_mult")
                + cfg["slices"] * cfg["ddim_steps"] * flash_sites([s2["slice_size"]] * 2, u2, "channel_mult"))
    _reset_counts(flash)
    t0 = time.perf_counter()
    result = run(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = flash.flash_forward.launches
    others = {k: v for k, v in _counts(flash).items() if k != "flash_fwd"}
    check(not any(others.values()), f"sampling launched other kernels: {others}")
    ct, labels = result["ct"], result["labels"]
    check(ct.shape == (1, cfg["slices"], *cfg["volume_shape"][1:]), f"CT shape {ct.shape}")
    check(labels.shape == (1, *cfg["volume_shape"]), f"label shape {labels.shape}")
    check(bool(np.isfinite(ct).all()), "CT has non-finite values")
    check(float(ct.min()) >= 0.0 and float(ct.max()) <= 1.0, f"CT outside [0, 1]: {ct.min()} {ct.max()}")
    check(int(labels.min()) >= 0 and int(labels.max()) < s1["num_classes"], "labels outside [0, 12)")
    for name in ("image.nii.gz", "pred.nii.gz"):
        check((Path(cfg["output_path"]) / "case_0000" / name).stat().st_size > 352, f"{name} not written")
    check(launches == expected, f"flash_fwd launched {launches} times on the main path, expected {expected}")
    sec = result["seconds"]
    print(f"path: stage 1 ({cfg['mask_steps']} steps at 64x128x128, base 64, bf16) {sec['stage1']:.3f} s, "
          f"{sec['stage1'] / cfg['mask_steps']:.4f} s/step; stage 2 ({cfg['slices']} slices x "
          f"{cfg['ddim_steps']} DDIM steps at 256x256, base 128, bf16) {sec['stage2']:.3f} s, "
          f"{sec['stage2'] / (cfg['slices'] * cfg['ddim_steps']):.4f} s/step; run() wall {wall:.3f} s "
          f"(incl. model init and NIfTI writes); flash_fwd launches {launches} = expected {expected}; "
          f"classes present {np.unique(labels).size}; card {card}", flush=True)
    return launches


def _counts(flash) -> dict:
    from jointimagegeneration_torch.ops import conv3d as conv

    return {"flash_fwd": flash.flash_forward.launches, "flash_bwd_dkv": flash.flash_bwd_dkv.launches,
            "flash_bwd_dq": flash.flash_bwd_dq.launches, "conv3d": conv.conv3d_igemm.launches,
            "conv3d_splitk_reduce": conv.conv3d_igemm.splitk_launches,
            "conv3d_stats_reduce": conv.channel_stats_reduce.launches}


def _reset_counts(flash) -> None:
    from jointimagegeneration_torch.ops import conv3d as conv

    flash.flash_forward.launches = flash.flash_bwd_dkv.launches = flash.flash_bwd_dq.launches = 0
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
        n_blocks = 8  # 1 + 1 down, 2 mid, 2 + 2 up
        want = {"conv3d": 2 * n_blocks * (1 + steps), "conv3d_splitk_reduce": 0,  # fp32: never split
                "conv3d_stats_reduce": n_blocks * (1 + steps)}
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
    places, and by as much)."""
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
        expected = {"flash_fwd": steps * sites, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
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
    return rows


def train_reference_phase(flash) -> float:
    """Three fp32 train steps (make_mask_train_step) on the card against the
    same steps on the CPU: same weights, same data, same draws.  Returns the
    worst relative difference.  The optimizer is SGD: Adam would normalise
    the rounding noise on the attention's key bias (whose gradient softmax
    cancels exactly) up to +-lr, and this phase holds the kernels, not Adam."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.data.datasets import SyntheticMaskDataset
    from jointimagegeneration_torch.train.optim import build_optimizer
    from jointimagegeneration_torch.train.state import EMATrainState
    from jointimagegeneration_torch.train.steps import make_mask_train_step

    configure_precision()
    cfg = {"num_classes": 4, "time_steps": 20, "bf16": False, "unet_openai": TRAIN_REF_UNET}
    ds = SyntheticMaskDataset(3, (8, 8, 8), 4)
    gen = torch.Generator().manual_seed(5)
    conds = [torch.rand((1, 8, 8, 8, 1), generator=gen) for _ in range(3)]
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
        state = EMATrainState(build_optimizer(list(model.unet.named_parameters()), "SGD", 1e-2), ema_decay=0.9)
        grads, apply = [], state.apply_gradients

        def record(g, apply=apply, grads=grads):  # keep each step's gradients, then apply them
            grads.append({k: v.detach().cpu() for k, v in g.items()})
            return apply(g)

        state.apply_gradients = record
        step = make_mask_train_step(model, torch.ones(4, device=device))
        noise = _CpuDrawnNoise(9, device)
        before = _counts(flash)
        losses, params = [], []
        for i in range(3):
            batch = {"mask": torch.from_numpy(ds[i]["mask"])[None].to(device), "image": conds[i].to(device)}
            metrics = step(state, batch, noise)
            check(float(metrics["grad_finite"]) == 1.0, f"train reference: non-finite gradients on {device}")
            losses.append(float(metrics["loss"]))
            params.append({n: p.detach().cpu().clone() for n, p in zip(state.names, state.params)})
        launched = {k: v - before[k] for k, v in _counts(flash).items()}
        runs.append((losses, grads, params, launched))
    (l_cpu, g_cpu, p_cpu, n_cpu), (l_gpu, g_gpu, p_gpu, n_gpu) = runs
    check(not any(n_cpu.values()) and all(n_gpu[k] for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"))
          and n_gpu["conv3d"] == n_gpu["conv3d_splitk_reduce"] == n_gpu["conv3d_stats_reduce"] == 0,
          f"train reference: kernel launches cpu {n_cpu}, card {n_gpu}")
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
    for i in range(3):
        worst["loss"] = max(worst["loss"], abs(l_gpu[i] - l_cpu[i]) / abs(l_cpu[i]))
        for kind, got, want in (("grad", g_gpu[i], g_cpu[i]), ("param", p_gpu[i], p_cpu[i])):
            for n, w in want.items():
                rel = (got[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                worst[kind] = max(worst[kind], rel)
                check(rel <= TRAIN_REF_TOL, f"train reference: step {i + 1} {kind} {n} differs by {rel:.3g} "
                                            f"of its max (tol {TRAIN_REF_TOL})")
    check(worst["loss"] <= TRAIN_REF_TOL, f"train reference: losses {l_gpu} vs {l_cpu}")
    print(f"train reference: 3 fp32 steps (base 64, T = 512 at the attention sites), card vs CPU: worst "
          f"relative diff loss {worst['loss']:.3g}, gradient {worst['grad']:.3g}, params {worst['param']:.3g} "
          f"(tol {TRAIN_REF_TOL}); launches on the card {n_gpu}", flush=True)
    return max(worst.values())


def _train_run(flash, cfg: dict, exp: str) -> tuple:
    """One `cli.train_mask.run` with the launch counts zeroed before it:
    (state, launches, wall seconds, stdout)."""
    from jointimagegeneration_torch.cli.train_mask import run

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


def train_path_phase(flash, card: str) -> dict:
    """Stage-1 training at full width through `cli.train_mask.run`, then a
    resumed run; returns the first run's launch counts and numbers."""
    from jointimagegeneration_torch.cli.sample import build_mask_sampler
    from jointimagegeneration_torch.core.checkpoint import CheckpointManager

    cfg = json.loads(json.dumps(STAGE1_TRAIN_CFG))
    cfg["output_path"] = str(ROOT / "build" / "chip_smoke" / "train")
    shutil.rmtree(cfg["output_path"], ignore_errors=True)
    logdir = Path(cfg["output_path"]) / "smoke"
    sites = flash_sites(cfg["dataset"]["volume_shape"], cfg["unet_openai"], "channel_mult")
    n_steps, n_eval = cfg["max_steps"], cfg["max_steps"] // cfg["validation_freq_steps"]
    expected = {"flash_fwd": sites * (n_steps + n_eval * cfg["eval_time_steps"]),
                "flash_bwd_dkv": sites * n_steps, "flash_bwd_dq": sites * n_steps,
                "conv3d": 0, "conv3d_splitk_reduce": 0, "conv3d_stats_reduce": 0}  # the unfused UNet
    torch.cuda.reset_peak_memory_stats()
    state, launches, wall, _ = _train_run(flash, cfg, "smoke")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches == expected, f"train path: launches {launches}, expected {expected}")
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    check([r["step"] for r in train] == list(range(1, n_steps + 1)), f"train path: logged steps {train}")
    check(all(math.isfinite(r["train/loss"]) for r in train), "train path: a logged loss is not finite")
    check(all(r["train/grad_finite"] == 1.0 and r["train/nonfinite_skipped"] == 0.0 for r in train),
          "train path: a step had non-finite gradients")
    dice = [r["val/dice"] for r in recs if "val/dice" in r and r["step"] == n_steps]
    check(len(dice) == 1 and 0.0 <= dice[0] <= 1.0, f"train path: val/dice at step {n_steps}: {dice}")
    steps = CheckpointManager(logdir / "checkpoints").all_steps()
    check(steps["rolling"] == [3, 6] and steps["best"] == [6], f"train path: checkpoints {steps}")
    fresh = build_mask_sampler(cfg, "cuda", seed=cfg["seed"]).unet
    moved = [(p - p0).abs().max().item() > 0 for p, p0 in zip(state.params, fresh.parameters())]
    check(sum(moved) > 0.9 * len(moved), f"train path: only {sum(moved)} of {len(moved)} params moved")
    ema_off = max((e - p).abs().max().item() for e, p in zip(state.ema, state.params))
    check(ema_off > 0, "train path: the EMA equals the params")
    sec = sorted(r["train/step_seconds"] for r in train[1:])  # step 1 carries cuDNN's first-call setup
    s_per_step = sec[len(sec) // 2]
    print(f"train path: stage 1 (64x128x128, base 64, bf16, AdamW + EMA) {n_steps} steps, warmed "
          f"{s_per_step:.4f} s/step (median of steps 2-{n_steps}; step 1 {train[0]['train/step_seconds']:.3f} s), "
          f"losses {[round(r['train/loss'], 2) for r in train]}, val/dice {dice[0]:.4f}, peak "
          f"torch.cuda.max_memory_allocated {peak_gib:.2f} GiB, run() wall {wall:.2f} s (incl. model init, "
          f"validation and three checkpoint writes); launches {launches} = expected; card {card}", flush=True)
    del state, fresh
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dict(cfg, load_from=True, max_steps=n_steps + 2)
    expected2 = {k: sites * 2 if k.startswith("flash") else 0 for k in expected}
    state2, launches2, wall2, printed = _train_run(flash, cfg2, "smoke")
    check(f"resumed from step {n_steps}" in printed, "train path: the rerun did not resume from step 6")
    check(state2.step == n_steps + 2, f"train path: resumed run ended at step {state2.step}")
    check(launches2 == expected2, f"train path (resumed): launches {launches2}, expected {expected2}")
    print(f"train path: resumed from step {n_steps} to {state2.step} in {wall2:.2f} s; launches {launches2} "
          f"= expected", flush=True)
    del state2
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "s_per_step": s_per_step, "peak_gib": peak_gib, "val_dice": dice[0]}


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

    rows = flash_phase(flash)
    bwd_rows = bwd_phase(flash)
    conv_rows, conv_edge = conv_phase(conv)
    reference_phase(flash)
    fused_ref = fused_reference_phase(flash)
    sample_launches = path_phase(flash, card)
    fused = fused_path_phase(flash, card)
    train_reference_phase(flash)
    train = train_path_phase(flash, card)

    main_row = rows[1]  # (16, 1024, 32): the stage-2 site, most of the sampling path's launches
    fwd_launches = {"two_stage_sampling": sample_launches, "stage1_training": train["launches"]["flash_fwd"]}
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
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]
    train_row = bwd_rows[0]  # (8, 2048, 32) bf16: the stage-1 training site
    for name, line, grads in (("flash_bwd_dkv", 250, ("dk", "dv")), ("flash_bwd_dq", 282, ("dq",))):
        part = name.rsplit("_", 1)[1]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "jointimagegeneration_torch/csrc/flash_bwd.cu",
            "replaces": f"jointimagegeneration_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train["launches"][name],
            "max_abs_err": max(r[f"err_{g}"] for r in bwd_rows for g in grads),
            "ms": train_row[f"{part}_ms"],
            "plain_ms": train_row["plain_ms"],  # the plain backward computes dq, dk and dv together
            "bound_ms": train_row[f"{part}_bound_ms"],
            "bound_by": train_row[f"{part}_bound_by"],
            "library_ms": train_row["library_ms"],  # SDPA's backward, all three gradients
            "shapes": bwd_rows,
        })
    fused_rows = [r for r in conv_rows + conv_edge if "activate" not in r["options"] and r["options"]]
    bare_rows = [r for r in conv_rows + conv_edge if "activate" in r["options"] or not r["options"]]
    fused_launches = {f"fused_{m}_sampling": fused[m]["launches"]["conv3d"] for m in ("kernel", "xla")}
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
                entry[f"{key}_launches"] = sum(fused[m]["launches"][f"conv3d_{key}"] for m in ("kernel", "xla"))
            entry["shapes"] = conv_rows
        if name == "conv3d_3x3":
            entry["note"] = ("no model path calls conv3d_3x3 itself (nor does the JAX package's); it is "
                             "the same function, entry point and kernel as conv3d_3x3_v2, whose launches "
                             "on the pallas_conv path these are")
        kernels.append(entry)
    print(f"fused: {json.dumps({'reference': fused_ref, 'paths': fused})}")
    print(f"train: {json.dumps(train)}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
