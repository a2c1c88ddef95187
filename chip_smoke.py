#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`jointimagegeneration_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a CUDA card

Phases (any failure exits non-zero and prints no result line):
  1. build: compiles every CUDA source of the main paths with nvcc, one nvcc
     per source, all started together;
  2. kernels: each kernel against its plain PyTorch version on the card at the
     main paths' shapes (max abs error against a stated tolerance), timed as
     many calls in one CUDA graph (device time, host launch cost excluded;
     the eager back-to-back time is kept beside it as `eager_ms`) beside the
     plain version, one PyTorch library call computing the same function
     (`library_ms`) and the card's bound; then checked, not timed, at ragged
     and wide-head shapes off the main paths.  The flash forward, then the
     flash backward (dkv and dq kernels) at the training shapes;
  3. reference: a tiny two-stage pipeline on the card against the same
     pipeline on the CPU (same weights, same noise);
  4. path: `cli.sample.run` on `configs/sample_two_stage.yml`'s full widths
     (stage 1 64x128x128 at base 64, stage 2 256x256 at base 128, bf16), with
     only the lengths cut: 4 mask steps, the full 128x256x256 handoff, and two
     chunks of 2 slices with the full DDIM-50 chain;
  5. train reference: three fp32 stage-1 train steps of a small UNet (T = 512
     at its attention sites, so the card runs the kernels) on the card against
     the same steps on the CPU: loss, every gradient and the params after
     each step;
  6. train path: `cli.train_mask.run` on `configs/stage1_mask.yml`'s full
     widths (64x128x128, 12 classes, base 64, bf16, AdamW, EMA), with only the
     lengths cut: 6 steps with checkpoints at 3 and 6 and one validation at 6,
     then a resumed run to step 8.
Before each main path (4, 6) every kernel launch counter is set to 0; after
it the counts must equal what the path implies.  The last lines are a JSON
line with the kernel numbers, the card's name and power limit, and
`{"ok": true, "device": {...}}`.  Imports neither JAX nor PyYAML.
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
    check(flash.flash_bwd_dkv.launches == flash.flash_bwd_dq.launches == 0,
          f"sampling launched backward kernels: {_counts(flash)}")
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
    return {"flash_fwd": flash.flash_forward.launches, "flash_bwd_dkv": flash.flash_bwd_dkv.launches,
            "flash_bwd_dq": flash.flash_bwd_dq.launches}


def _reset_counts(flash) -> None:
    flash.flash_forward.launches = flash.flash_bwd_dkv.launches = flash.flash_bwd_dq.launches = 0


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
    check(not any(n_cpu.values()) and all(n_gpu.values()),
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
                "flash_bwd_dkv": sites * n_steps, "flash_bwd_dq": sites * n_steps}
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
    expected2 = {k: sites * 2 for k in expected}
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
        from jointimagegeneration_torch.ops import flash_attention as flash
        from jointimagegeneration_torch.ops.cuda import build
    except ImportError as e:
        print(f"chip_smoke: the jointimagegeneration_torch package is not here ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build_s = build.build_all([flash.FLASH_SOURCE, flash.FLASH_BWD_SOURCE])
    print(f"build: {build_s} ({time.perf_counter() - t0:.2f} s wall)", flush=True)

    rows = flash_phase(flash)
    bwd_rows = bwd_phase(flash)
    reference_phase(flash)
    sample_launches = path_phase(flash, card)
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
    print(f"train: {json.dumps(train)}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
