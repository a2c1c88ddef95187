#!/usr/bin/env python3
"""Time the flash backward kernels under each launch-plan variant, or trace
where their k loop spends its clocks, on one NVIDIA card.

    python3 scripts/bench_flash_bwd.py            # the plan variants
    python3 scripts/bench_flash_bwd.py --fp32     # the fp32 kernels under each split count
    python3 scripts/bench_flash_bwd.py --trace    # SM clocks per phase of the k loop

Plan variants: at every bf16 row of `chip_smoke.BWD_SHAPES`, the dq kernel
(with delta) with one and with two warpgroups per block (the dkv kernel, which
has one, beside it), each variant's gradients checked against the plain
version (chip_smoke's BWD_REL_TOL) and graph-timed as chip_smoke does.

fp32: at every fp32 row of `chip_smoke.BWD_SHAPES` and `CROSS_SHAPES`, the dq
(with delta) and dkv kernels with their loops split 1, 2, 4 and 8 ways (and the
planner's count), each with its split reduce, the gradients checked against
the plain version at 1e-4 of their max and graph-timed; the share of each
kernel's FMA bound beside it.  The planner's split rule
(`ops.flash_attention.f32_bwd_splits`) rests on these numbers.

Trace: csrc/flash_bwd.cu is built with JIG_FLASH_TRACE = 1, whose
kernels sum, in thread 0 of each warpgroup, the SM clocks (clock64) spent in
each phase of their k loop; one launch of each kernel at the planner's plans
at (8, 2048, 32) and (16, 4096, 32) prints the mean clocks per loop iteration
of each phase, over every warpgroup of the grid.

Prints one line per variant with the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from jointimagegeneration_torch.ops import flash_attention as flash  # noqa: E402
from jointimagegeneration_torch.ops.cuda import build  # noqa: E402

TRACE_SHAPES = [(8, 2048, 32), (16, 4096, 32)]

def f32_variant(plan: flash.FlashBwdPlan, splits: int) -> flash.FlashBwdPlan:
    """The fp32 plan with both kernels' loops split `splits` ways."""
    split = lambda kp: dataclasses.replace(kp, splits=splits, grid=kp.grid // kp.splits * splits)
    return dataclasses.replace(plan, dkv=split(plan.dkv), dq=split(plan.dq))


def bench_fp32(card: str) -> None:
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = [((bh, t, t, d), where) for (bh, t, d), dtype, where in smoke.BWD_SHAPES if dtype == torch.float32]
    rows += [(shape, where) for shape, dtype, where in smoke.CROSS_SHAPES if dtype == torch.float32]
    for (bh, tq, tk, d), where in rows:
        q, k, v, do = smoke._attention_inputs(g, bh, tq, tk, d, torch.float32)
        o, lse = flash.flash_forward(q, k, v)
        want = flash.flash_backward_plain(q, k, v, o, lse, do)
        base = flash.plan_flash_bwd(bh, tq, tk, d, torch.float32)
        fma_ms = {n: k * bh * tq * tk * d / smoke.PEAK_FLOPS[torch.float32] * 1e3 for n, k in (("dq", 6), ("dkv", 8))}
        for splits in sorted({1, 2, 4, 8, base.dkv.splits}):
            if splits > -(-min(tq, tk) // base.dkv.rows):
                continue
            plan = f32_variant(base, splits)
            dq, delta = flash.flash_bwd_dq(q, k, v, o, do, lse, plan)
            dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, plan)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                err = (a - b).abs().max().item()
                smoke.check(err <= 1e-4 * b.abs().max().item(),
                            f"fp32 {name} disagrees at {(bh, tq, tk, d)} with {splits} splits: {err}")
            dq_ms, _ = smoke.time_ms(lambda: flash.flash_bwd_dq(q, k, v, o, do, lse, plan), 20)
            dkv_ms, _ = smoke.time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, plan), 20)
            mark = " (the plan's)" if splits == base.dkv.splits == base.dq.splits else ""
            print(f"flash_bwd fp32 plan {[bh, tq, tk, d]} ({where}): {splits} splits{mark}, blocks dkv "
                  f"{plan.dkv.grid} dq {plan.dq.grid}: dq {dq_ms:.4f} ms ({100 * fma_ms['dq'] / dq_ms:.1f}% of its "
                  f"FMA bound), dkv {dkv_ms:.4f} ms ({100 * fma_ms['dkv'] / dkv_ms:.1f}%), sum "
                  f"{dq_ms + dkv_ms:.4f} ms; card {card}", flush=True)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()


def variant(plan: flash.FlashBwdPlan, wg: int) -> flash.FlashBwdPlan:
    """The plan with `wg` warpgroups per dq block."""
    dq = dataclasses.replace(plan.dq, warpgroups=wg, threads=128 * wg,
                             smem_bytes=flash._bwd_smem("dq", plan.head_width, wg))
    return dataclasses.replace(plan, dq=dq)


PHASES = {"dq": ["stage wait", "barrier and refill issue", "S", "P", "dP", "dS", "dQ and wait"],
          "dkv": ["stage wait", "barrier and refill issue", "S", "P", "dV issue and dP", "dS", "dK and wait"]}


def profiling_builds(defines: dict, source: str = flash.FLASH_BWD_SOURCE) -> dict:
    """{label: (ctypes library, {entry name: ctypes function})} of
    csrc/<source>.cu built with each label's -D define, into build/probe/,
    one nvcc per build, all started together."""
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, define in defines.items():
        lib = out_dir / f"{source}_{label}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-D{define}", "-o", str(lib),
               str(build.CSRC_DIR / f"{source}.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        smoke.check(proc.returncode == 0, f"nvcc failed for the {label} build:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        out[label] = (cdll, {name: flash._bind(cdll, name) for name, (src, _) in flash._ENTRY_POINTS.items()
                             if src == source})
    return out


def trace(card: str) -> None:
    cdll, table = profiling_builds({"trace": "JIG_FLASH_TRACE=1"})["trace"]
    set_trace = cdll.jig_flash_bwd_trace
    set_trace.argtypes = [ctypes.c_void_p]
    real = flash._kernel_fn
    g = torch.Generator(device="cuda").manual_seed(5)
    for bh, t, d in TRACE_SHAPES:
        q, k, v, do = smoke._attention_inputs(g, bh, t, t, d, torch.bfloat16)
        o, lse = flash.flash_forward(q, k, v)
        plan = flash.plan_flash_bwd(bh, t, t, d, torch.bfloat16)
        _, delta = flash.flash_bwd_dq(q, k, v, o, do, lse)
        flash._kernel_fn = table.__getitem__
        try:
            for kernel, kp in (("dq", plan.dq), ("dkv", plan.dkv)):
                buf = torch.zeros((kp.grid * kp.warpgroups, len(PHASES[kernel])), dtype=torch.int64, device="cuda")
                smoke.check(set_trace(buf.data_ptr()) == 0, "jig_flash_bwd_trace failed")
                if kernel == "dq":
                    flash.flash_bwd_dq(q, k, v, o, do, lse)
                else:
                    flash.flash_bwd_dkv(q, k, v, do, lse, delta)
                torch.cuda.synchronize()
                iters = kp.grid * (-(-t // flash.TILE))  # every block walks every tile of the other side
                per = (buf.sum(dim=0).double() / iters).tolist()
                parts = ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES[kernel], per))
                print(f"flash_bwd trace {[bh, t, t, d]} {kernel} ({kp.warpgroups} warpgroup(s) per block): SM clocks "
                      f"per iteration of one warpgroup: {parts}; total {sum(per):.0f}; card {card}", flush=True)
        finally:
            flash._kernel_fn = real
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_flash_bwd: needs a CUDA card", file=sys.stderr)
        return 1
    card = smoke.card_line()
    if sys.argv[1:] == ["--trace"]:
        trace(card)
        return 0
    if sys.argv[1:] == ["--fp32"]:
        bench_fp32(card)
        return 0
    g = torch.Generator(device="cuda").manual_seed(3)
    for (bh, t, d), dtype, where in smoke.BWD_SHAPES:
        if dtype != torch.bfloat16:
            continue
        q, k, v, do = smoke._attention_inputs(g, bh, t, t, d, dtype)
        o, lse = flash.flash_forward(q, k, v)
        want = flash.flash_backward_plain(q, k, v, o, lse, do)
        base = flash.plan_flash_bwd(bh, t, t, d, dtype)
        for wg in (1, 2):
            plan = variant(base, wg)
            dq, delta = flash.flash_bwd_dq(q, k, v, o, do, lse, plan)
            dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, plan)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                err = (a.float() - b.float()).abs().max().item()
                smoke.check(err <= smoke.BWD_REL_TOL[dtype] * b.float().abs().max().item(),
                            f"{name} disagrees at {(bh, t, d)} with {wg} dq warpgroups: {err}")
            dq_ms, _ = smoke.time_ms(lambda: flash.flash_bwd_dq(q, k, v, o, do, lse, plan), 20)
            dkv_ms, _ = smoke.time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta, plan), 20)
            mark = " (the plan's)" if wg == base.dq.warpgroups else ""
            print(f"flash_bwd plan {[bh, t, t, d]} ({where}): dq with {wg} warpgroup(s) per block{mark}: "
                  f"dq {dq_ms:.4f} ms, dkv {dkv_ms:.4f} ms, sum {dq_ms + dkv_ms:.4f} ms; card {card}", flush=True)
        del q, k, v, do, o, lse, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
