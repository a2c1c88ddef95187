#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/profile_torch_path.py [--steps N] [--out build/profile_torch_path.json]

At the full widths that `chip_smoke.py` drives (its `TWO_STAGE_CFG`, from
`configs/sample_two_stage.yml`, its `STAGE1_TRAIN_CFG`, from
`configs/stage1_mask.yml`, and its `STAGE2_TRAIN_CFG`, from
`configs/stage2_ldm.yml`; bf16, seeded random weights with the zero-init
kernels un-zeroed as the sample CLI does), times one stage-1 denoise step at
64x128x128 (the unfused UNet, then the same weights with
use_fused_resblock='kernel', whose convs are `csrc/conv3d.cu`'s kernel), one
stage-2 DDIM step at 256x256 and 512x512, one stage-1 train step (forward,
backward, AdamW, EMA) at 64x128x128, untexted and text-guided (its
`TEXT_TRAIN_CFG`: `selfattn`, embed 768, the refiner in the state, a 4-token
synthetic context), and one stage-2 train step (b = 1, AdamW,
LitEma warmup EMA; the trainer's fresh init) at 512x512 with CUDA events,
then traces a few steps of each with torch.profiler and sums the kernels'
device time by kind (convolution by cuDNN, the port's conv3d kernel,
flash_fwd, flash_bwd, GroupNorm/elementwise,
optimizer, matmul, ...).  Prints one JSON line per step kind and writes them
all to `--out`.  The device's idle share is 1 - (kernel time / step wall
time); the train step's peak memory is torch.cuda.max_memory_allocated.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (STAGE1_TRAIN_CFG, STAGE2_TRAIN_CFG, TEXT_TRAIN_CFG, TWO_STAGE_CFG, conv_flags,  # noqa: E402
                        fused_conv_calls)
from jointimagegeneration_torch.cli.common import build_mask_dataset  # noqa: E402
from jointimagegeneration_torch.cli.sample import build_mask_sampler, build_slice_ldm, load_weights  # noqa: E402
from jointimagegeneration_torch.core.logging import kind_of  # noqa: E402
from jointimagegeneration_torch.core.runtime import configure_precision  # noqa: E402
from jointimagegeneration_torch.data.datasets import SyntheticSliceDataset  # noqa: E402
from jointimagegeneration_torch.diffusion.ddim import DDIMParams, ddim_step  # noqa: E402
from jointimagegeneration_torch.diffusion.noise import NoiseSource  # noqa: E402
from jointimagegeneration_torch.ops import conv3d as conv  # noqa: E402
from jointimagegeneration_torch.ops import flash_attention as flash  # noqa: E402
from jointimagegeneration_torch.ops.cuda.build import build_all  # noqa: E402
from jointimagegeneration_torch.train.optim import build_optimizer  # noqa: E402
from jointimagegeneration_torch.train.state import EMATrainState  # noqa: E402
from jointimagegeneration_torch.train.steps import make_ldm_train_step, make_mask_train_step  # noqa: E402

S1, S2 = TWO_STAGE_CFG["stage1"], TWO_STAGE_CFG["stage2"]  # the widths chip_smoke.py drives
NOISE = TWO_STAGE_CFG["fresh_init_noise"]


def conv_ms_by_level(prof, steps: int) -> dict:
    """Device ms per fused 'kernel' step of the conv kernels (conv, split-K
    reduce, stats reduce) by UNet level: the trace's conv3d kernels in launch
    order, matched to the launch planner's sequence for the forward's calls
    (`chip_smoke.fused_conv_calls`).  Empty if the trace does not hold
    `steps` times that sequence."""
    spatial = S1["dataset"]["volume_shape"]
    seq = []
    for shape, cout, opts in fused_conv_calls(S1["unet_openai"], spatial, "kernel"):
        level = (spatial[0] // shape[1]).bit_length() - 1
        seq += [level] * conv.plan_conv3d(*shape, cout, torch.bfloat16, conv_flags(opts)).n_launches
    evs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and kind_of(e.name) == "conv3d_kernel"), key=lambda e: e.time_range.start)
    if len(evs) != steps * len(seq):
        return {}
    by_level = {}
    for i, e in enumerate(evs):
        lv = f"L{seq[i % len(seq)]}"
        by_level[lv] = by_level.get(lv, 0.0) + e.time_range.elapsed_us() / steps / 1e3
    return by_level


def measure(label: str, step, steps: int, per_level: bool = False) -> dict:
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    counters = (flash.flash_forward, flash.flash_bwd_dkv, flash.flash_bwd_dq, flash.flash_bwd_reduce,
                conv.conv3d_igemm, conv.channel_stats_reduce)
    for c in counters:
        c.launches = 0
    conv.conv3d_igemm.splitk_launches = 0
    torch.cuda.reset_peak_memory_stats()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    launches = {c.__name__: c.launches / steps for c in counters}
    launches["conv3d_splitk_reduce"] = conv.conv3d_igemm.splitk_launches / steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_kind, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue  # operator and annotated-range rows (Optimizer.step) repeat their kernels' time
        ms = e.self_device_time_total / steps / 1e3
        kernels.append((ms, e.count // steps, e.key))
        by_kind[kind_of(e.key)] = by_kind.get(kind_of(e.key), 0.0) + ms
    kernel_ms = sum(by_kind.values())
    kernels.sort(reverse=True)
    row = {"step": label, "step_ms": step_ms, "kernel_ms": kernel_ms,
           "device_idle_share": (1 - kernel_ms / step_ms) if kernel_ms else None,
           "launches_per_step": launches, "peak_gib": peak_gib,
           "kernel_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
           "top_kernels": [{"ms": ms, "calls": n, "name": name[:120]} for ms, n, name in kernels[:12]]}
    if per_level:
        row["conv3d_kernel_ms_by_level"] = conv_ms_by_level(prof, steps)
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="build/profile_torch_path.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_path: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    configure_precision()
    build_all([flash.FLASH_SOURCE, flash.FLASH_BWD_SOURCE, conv.CONV3D_SOURCE])
    rows = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        ms = build_mask_sampler(S1, "cuda")
        load_weights(ms.unet, None, NOISE, 1)
        print(f"stage-1 model built in {time.perf_counter() - t0:.2f} s", flush=True)
        noise = NoiseSource(0, "cuda")
        shape = (1, 64, 128, 128)
        xt = torch.nn.functional.one_hot(torch.randint(0, 12, shape, device="cuda"), 12).float()
        cond = torch.zeros((*shape, 1), device="cuda")
        t = torch.full((1,), 500, device="cuda")
        rows.append(measure("stage1_denoise_64x128x128", lambda: ms.denoise_step(noise, xt, t, cond=cond),
                            args.steps))
        fused = build_mask_sampler(S1, "cuda", use_fused_resblock="kernel")
        fused.unet.load_state_dict(ms.unet.state_dict())
        rows.append(measure("stage1_denoise_fused_kernel_64x128x128",
                            lambda: fused.denoise_step(noise, xt, t, cond=cond), args.steps, per_level=True))
        del ms, fused, xt
        torch.cuda.empty_cache()

        ldm = build_slice_ldm(S2, "cuda")
        load_weights(ldm.unet, None, NOISE, 2)
        ddim = DDIMParams.create(ldm.diffusion, 50)
        for size in (256, 512):
            x = torch.randn(1, size, size, 1, device="cuda")
            c = torch.rand(1, size, size, 2, device="cuda")
            tb = torch.full((1,), int(ddim.timesteps[25]), device="cuda")

            def step():
                e = ldm.apply_model(x, tb, cond=c)
                return ddim_step(ddim, noise, x, e.float(), 25)

            rows.append(measure(f"stage2_ddim_step_{size}x{size}", step, args.steps))
        del ldm, x, c
        torch.cuda.empty_cache()

    for cfg, label in ((STAGE1_TRAIN_CFG, "stage1_train_step_64x128x128"),
                       (TEXT_TRAIN_CFG, "stage1_text_train_step_64x128x128")):
        model = build_mask_sampler(cfg, "cuda", seed=cfg["seed"])  # the CLI's init
        opt = cfg["optim"]
        state = EMATrainState(build_optimizer(model.named_parameters(), opt["name"], opt["learning_rate"],
                                              opt["lr_function"], opt["lr_params"], total_steps=100_000),
                              ema_decay=cfg["polyak_alpha"])
        item = build_mask_dataset(cfg)[0]
        batch = {k: torch.from_numpy(item[k])[None].cuda() for k in ("mask", "image", "context") if k in item}
        train_step = make_mask_train_step(model, torch.ones(12, device="cuda"))
        rows.append(measure(label, lambda: train_step(state, batch, noise), args.steps))
        del model, state, batch, train_step
        torch.cuda.empty_cache()

    cfg2 = STAGE2_TRAIN_CFG
    ldm = build_slice_ldm(cfg2["model"], "cuda", seed=cfg2["seed"])  # the CLI's init
    lr = cfg2["accumulate_grad_batches"] * cfg2["batch_size"] * cfg2["model"]["base_learning_rate"]
    state = EMATrainState(build_optimizer(ldm.named_parameters(), "AdamW", lr, total_steps=100_000),
                          ema_decay=0.9999, ema_warmup=True)
    item = SyntheticSliceDataset(1, tuple(cfg2["dataset"]["slice_shape"]), cfg2["dataset"]["depth"])[0]
    batch = {k: torch.from_numpy(item[k])[None].cuda() for k in ("image", "cond")}
    ldm_step = make_ldm_train_step(ldm)
    rows.append(measure("stage2_train_step_512x512", lambda: ldm_step(state, batch, noise), args.steps))
    for r in rows:
        r["card"] = card
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
