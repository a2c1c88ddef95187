"""Tiny configurations and traffic of each driver, for the CPU tests: the
cells' shapes cut far below their published widths, never benchmarked."""

from __future__ import annotations

import json
import time

import torch

from perfbench import harness

LDM = {"dtype": "bfloat16", "model_channels": 32, "channel_mult": [1, 2], "num_res_blocks": 1,
       "attention_resolutions": [2], "num_head_channels": 16, "image_channels": 1, "cond_channels": 2,
       "timesteps": 1000, "beta_schedule": "linear", "linear_start": 0.0015, "linear_end": 0.0195}
CCDM = {"dtype": "bfloat16", "num_classes": 12, "cond_channels": 1, "model_channels": 32, "channel_mult": [1, 2],
        "num_res_blocks": 1, "attention_resolutions": [2], "num_head_channels": 16, "time_steps": 1000,
        "beta_schedule": "cosine", "step_T_sample": "majority",
        "feature_cond_encoder": {"type": "selfattn", "embed_dim": 48, "n_heads": 2, "model_depth": 2, "d_head": 8,
                                 "dropout": 0.2, "train": True}}
# limits between the tiny bf16 program's readings and the fp8 control's
WORKLOADS = {
    "slices": (LDM, {"driver": "slices", "rate_metric": "ct_slices_per_s", "batch": 4, "slice_size": 16, "depth": 8,
                     "mask_shape": [4, 8, 8], "num_classes": 12, "ddim_steps": 4, "ddim_eta": 0.0,
                     "check_slices": 2,
                     "limits": {"slice_rms": 0.005, "slice_max_abs": 0.05, "handoff_max_abs": 0.0}}),
    "mask": (CCDM, {"driver": "mask", "rate_metric": "mask_steps_per_s", "batch": 1, "mask_shape": [4, 8, 8],
                    "volume_shape": [8, 16, 16], "mask_steps": 6, "context_tokens": 8, "check_steps": 2,
                    "trace_steps": 2,
                    "limits": {"label_gap": 0.1, "start_mismatch": 0, "handoff_max_abs": 0.0}}),
    "train_ldm": (LDM, {"driver": "train", "rate_metric": "train_steps_per_s", "batch": 1, "slice_size": 16,
                        "num_classes": 12, "loader_threads": 2, "ema_decay": 0.9999, "ema_warmup": True,
                        "check_steps": 3, "trace_steps": 2,
                        "optimizer": {"learning_rate": 2e-6, "lr_function": None, "total_steps": 100000},
                        "limits": {"loss_gap": 0.004, "grad_gap": 0.04, "ema_step_gap": 0.05}}),
}
# the cell of BENCHMARK.json whose metrics each tiny kind reports
CELL = {"slices": "ldm_unet2d.sample_256_b4", "mask": "ccdm_unet3d.sample_b1", "train_ldm": "ldm_unet2d.train_512_b1"}
# the metrics of a cell that BENCHMARK.json does not name (yet): the train kind's, as its cell reports them
UNNAMED = {"ldm_unet2d.train_512_b1": ([("train_steps_per_s", "steps/s"), ("setup_s", "s")],
                                       {f"{m}.train": unit for m, unit in (
                                           ("optimizer_ms", "ms"), ("loader_wait_ms", "ms"),
                                           ("norm_elementwise_ms", "ms"), ("flash_roofline", "%"), ("mfu", "%"),
                                           ("device_idle_share", "%"))})}


def tiny_run(kind: str, seed: int = 2**31 + 12345, trace: bool = False, seconds: float = 0.5,
             dtype: str = "bfloat16", limits=None) -> harness.Run:
    cfg, wl = WORKLOADS[kind]
    wl = dict(wl, limits=limits or wl["limits"])
    torch.set_num_threads(2)
    return harness.Run({"name": CELL[kind], "chips": 1}, dict(cfg, dtype=dtype), wl, seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter())


def execute(run: harness.Run) -> dict:
    """The harness's run of `run`, with the metrics that its cell of
    BENCHMARK.json reports (or, for a cell it does not name, `UNNAMED`'s)."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    e2e, layer = UNNAMED.get(run.cell["name"]) or harness.cell_metrics(bench, run.cell["name"])
    readers = {m: (unit, harness.load_part("layer_metrics", m).read) for m, unit in layer.items()}
    return harness.execute(run, harness.load_part("drivers", run.workload["driver"]), readers, e2e)
