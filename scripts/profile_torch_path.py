#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/profile_torch_path.py [--steps N] [--cells] [--out build/profile_torch_path.json]

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
optimizer, matmul, ...) and counts each kernel's launches per step (the
GroupNorm pair's, `group_norm_act`, also per UNet call in the two cells).  Before those, the two sampling cells of the
benchmark (`perfbench/configs`, `perfbench/workloads`, seeded weights):
`ldm_unet2d.sample_256_b4`, chains of 10 DDIM-50 nodes at 256x256, b = 4,
and `ccdm_unet3d.sample_b1`, 10-step mask samples at 64x128x128 with the
text refiner over a 512-token report; `--cells` runs those two alone.
Prints one JSON line per step kind and writes them all to `--out`.

The trace records the card alone (host operators' recording would slow the
host and read as idle), with the program's span recorder on
(`core.logging.span`).  The device's idle share is 1 - the union of the
card's kernel and copy intervals over the traced steps' wall time, as
`perfbench/trace.py` reckons it, and each idle gap goes to the innermost span
open on the host when it began (`perfbench.trace.reduce_events` fed
`core.logging.intervals()`): `idle_ms_by_span`, and by UNet level
(`levels`: head, L0..L4 for the down and up blocks of a level, mid, tail)
beside the level's host issue ms and card ms, all per UNet call (from a
second profile with the UNet calls eager, since a replayed CUDA graph records
no block span; the rest with the calls as the program runs them, its
`unet_graph` the captures, replays and share of calls replayed); with a
sampler loop, `card_backlog_ms` is the median over its steps of the card's
open less the host's.  The train step's peak memory is
torch.cuda.max_memory_allocated.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# Each cell is profiled again after its own and the earlier cells' CUDA graph
# captures: keep CUPTI up between the profiles (`torch.profiler` does so where it
# knows of graphs); so set, every cell's kernels were seen.
os.environ.setdefault("TEARDOWN_CUPTI", "0")

from chip_smoke import (STAGE1_TRAIN_CFG, STAGE2_TRAIN_CFG, TEXT_TRAIN_CFG, TWO_STAGE_CFG, conv_flags,  # noqa: E402
                        fused_conv_calls)
from jointimagegeneration_torch.cli.common import build_mask_dataset  # noqa: E402
from jointimagegeneration_torch.cli.sample import build_mask_sampler, build_slice_ldm, load_weights  # noqa: E402
from jointimagegeneration_torch.core import logging as spans  # noqa: E402
from jointimagegeneration_torch.core.runtime import configure_precision  # noqa: E402
from jointimagegeneration_torch.data.datasets import SyntheticSliceDataset  # noqa: E402
from jointimagegeneration_torch.diffusion.ddim import DDIMParams, ddim_step  # noqa: E402
from jointimagegeneration_torch.diffusion.noise import NoiseSource  # noqa: E402
from jointimagegeneration_torch.nn.graphed import eager_unet, unet_graph  # noqa: E402
from jointimagegeneration_torch.ops import conv3d as conv  # noqa: E402
from jointimagegeneration_torch.ops import flash_attention as flash  # noqa: E402
from jointimagegeneration_torch.ops import group_norm as gn  # noqa: E402
from jointimagegeneration_torch.ops.cuda.build import build_all  # noqa: E402
from jointimagegeneration_torch.train.optim import build_optimizer  # noqa: E402
from jointimagegeneration_torch.train.state import EMATrainState  # noqa: E402
from jointimagegeneration_torch.train.steps import make_ldm_train_step, make_mask_train_step  # noqa: E402
from perfbench import program  # noqa: E402
from perfbench.harness import load_json  # noqa: E402
from perfbench.kinds import kind_of  # noqa: E402
from perfbench.trace import reduce_events  # noqa: E402

S1, S2 = TWO_STAGE_CFG["stage1"], TWO_STAGE_CFG["stage2"]  # the widths chip_smoke.py drives
NOISE = TWO_STAGE_CFG["fresh_init_noise"]


def conv_ms_by_level(device: list, steps: int) -> dict:
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
    evs = [(s, e) for s, e, name in sorted(device) if kind_of(name) == "conv3d_kernel"]
    if len(evs) != steps * len(seq):
        return {}
    by_level = {}
    for i, (s, e) in enumerate(evs):
        lv = f"L{seq[i % len(seq)]}"
        by_level[lv] = by_level.get(lv, 0.0) + (e - s) / steps / 1e6
    return by_level


def level_of(name: str) -> str:
    """A UNet span's level: 'unet.down_2_1_res' -> 'L2', 'unet.mid_attn' ->
    'mid', 'unet.head' -> 'head'."""
    part = name.split(".", 1)[1]
    if part.startswith(("down_", "up_")):
        return f"L{part.split('_')[1]}"
    return "mid" if part.startswith("mid_") else part


def level_table(recs: list, idle_by_span: dict) -> dict:
    """{level: {issue_ms, card_ms, idle_ms}} per UNet call of the UNet's
    block spans: host issue, card time and the card's idle time while the
    host was in them."""
    calls = sum(r.name == "unet" for r in recs)
    if not calls:
        return {}
    out = {}
    for r in recs:
        if r.name.startswith("unet."):
            row = out.setdefault(level_of(r.name), {"issue_ms": 0.0, "card_ms": None, "idle_ms": 0.0})
            row["issue_ms"] += (r.host_close - r.host_open) / 1e6 / calls
            if r.card_open is not None:
                row["card_ms"] = (row["card_ms"] or 0.0) + (r.card_close - r.card_open) / 1e6 / calls
    for name, seconds in idle_by_span.items():
        if name.startswith("unet.") and level_of(name) in out:
            out[level_of(name)]["idle_ms"] += 1e3 * seconds / calls
    return out


def profiled(step, steps: int) -> tuple:
    """(span records, the reduced trace, the card's (start, end, name) events)
    of `steps` calls of `step` under a CUDA-only profile."""
    spans.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        w0 = time.time_ns()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        w1 = time.time_ns()
    recs = spans.records()
    spans.reset_spans()
    device = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
    return recs, reduce_events(device, spans.intervals(recs), (w0, w1)), device


def measure(label: str, step, steps: int, per_level: bool = False, unet=None) -> dict:
    """With `unet`, its calls replay CUDA graphs where they are eligible
    (`nn/graphed.py`; the row's `unet_graph`), and the per-level table comes
    from a second profile with the calls eager: only eager calls record the
    block spans it reads."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    counters = (flash.flash_forward, flash.flash_bwd_dkv, flash.flash_bwd_dq, flash.flash_bwd_reduce,
                conv.conv3d_igemm, conv.channel_stats_reduce, gn.group_norm_act)
    for c in counters:
        c.launches = 0
    conv.conv3d_igemm.splitk_launches = 0
    calls = []
    hook = unet.register_forward_pre_hook(lambda *_: calls.append(1)) if unet is not None else None
    graph0 = (unet_graph.captures, unet_graph.replays)
    torch.cuda.reset_peak_memory_stats()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    if hook is not None:
        hook.remove()
    step_ms = start.elapsed_time(end) / steps
    launches = {c.__name__: c.launches / steps for c in counters}
    launches["conv3d_splitk_reduce"] = conv.conv3d_igemm.splitk_launches / steps
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    graph = {"captures": unet_graph.captures - graph0[0], "replays": unet_graph.replays - graph0[1]}

    recs, traced, device = profiled(step, steps)
    levels = level_table(recs, traced.idle_by_span)
    if unet is not None:
        with eager_unet():
            eager_recs, eager_traced, _ = profiled(step, steps)
        levels = level_table(eager_recs, eager_traced.idle_by_span)
    counts = {}
    for _, _, name in device:
        counts[name] = counts.get(name, 0) + 1
    kernels = sorted(((1e3 * s / steps, counts[name] // steps, name) for name, s in traced.by_name.items()),
                     reverse=True)
    waits = [(r.card_open - r.host_open) / 1e6 for r in recs if r.name == "sampler.step" and r.card_open is not None]
    row = {"step": label, "step_ms": step_ms, "kernel_ms": 1e3 * sum(traced.by_kind.values()) / steps,
           "traced_step_ms": 1e3 * traced.window_s / steps, "busy_ms": 1e3 * traced.busy_s / steps,
           "device_idle_share": 1 - traced.busy_s / traced.window_s if traced.window_s > 0 else None,
           "launches_per_step": launches, "peak_gib": peak_gib,
           "kernel_ms_by_kind": {k: 1e3 * s / steps for k, s in sorted(traced.by_kind.items(), key=lambda kv: -kv[1])},
           "top_kernels": [{"ms": ms, "calls": n, "name": name[:120]} for ms, n, name in kernels[:12]],
           "idle_ms_by_span": {k: 1e3 * s / steps
                               for k, s in sorted(traced.idle_by_span.items(), key=lambda kv: -kv[1])},
           "levels": levels,
           "card_backlog_ms": statistics.median(waits) if waits else None}
    if calls:
        row["group_norm_act_per_unet_call"] = launches["group_norm_act"] * steps / len(calls)  # the window's calls
        row["unet_graph"] = dict(graph, replayed_share=graph["replays"] / len(calls))
    if per_level:
        row["conv3d_kernel_ms_by_level"] = conv_ms_by_level(device, steps)
    print(json.dumps(row), flush=True)
    return row


def cell_rows(steps: int) -> list:
    """The benchmark's two sampling cells, built as its drivers build them."""
    rows = []
    with torch.inference_mode():
        cfg, p = load_json("configs", "ldm_unet2d"), load_json("workloads", "ldm_unet2d.sample_256_b4")
        ldm = program.slice_ldm(cfg, "cuda")
        program.load_seeded(ldm.unet, 1, "cuda")
        ddim = DDIMParams.create(ldm.diffusion, p["ddim_steps"], "uniform", p["ddim_eta"])
        cond = torch.rand((p["batch"], p["slice_size"], p["slice_size"], 2), device="cuda")
        noise = NoiseSource(0, "cuda")
        rows.append(measure("cell ldm_unet2d.sample_256_b4: 10 DDIM nodes", lambda: ldm.sample_slice(
            noise, cond, ddim, start_index=10), steps, unet=ldm.unet))
        del ldm
        torch.cuda.empty_cache()
        cfg, p = load_json("configs", "ccdm_unet3d"), load_json("workloads", "ccdm_unet3d.sample_b1")
        ms = program.mask_sampler(cfg, "cuda")
        program.load_seeded(ms.unet, 1, "cuda")
        program.load_seeded(ms.refiner, 2, "cuda")
        shape = (p["batch"], *p["mask_shape"])
        mcond = torch.zeros((*shape, cfg["cond_channels"]), device="cuda")
        ctx = torch.randn((p["batch"], p["context_tokens"], cfg["feature_cond_encoder"]["embed_dim"]), device="cuda")
        rows.append(measure("cell ccdm_unet3d.sample_b1: refiner + 10 steps", lambda: ms.sample(
            noise, shape, cond=mcond, num_steps=10, context=ctx), steps, unet=ms.unet))
        del ms
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--cells", action="store_true", help="the benchmark's two sampling cells alone")
    ap.add_argument("--out", default="build/profile_torch_path.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_path: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    configure_precision()
    build_all([flash.FLASH_SOURCE, flash.FLASH_BWD_SOURCE, conv.CONV3D_SOURCE, gn.GROUP_NORM_SOURCE])
    rows = cell_rows(args.steps)
    if args.cells:
        return write(rows, card, args.out)
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
    return write(rows, card, args.out)


def write(rows: list, card: str, path: str) -> int:
    for r in rows:
        r["card"] = card
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
