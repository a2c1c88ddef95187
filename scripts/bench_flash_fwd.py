#!/usr/bin/env python3
"""Time the flash forward kernel under each launch-plan variant, or trace
where its k loop spends its clocks, on one NVIDIA card.

    python3 scripts/bench_flash_fwd.py            # one vs two warpgroups per block
    python3 scripts/bench_flash_fwd.py --fp32     # the fp32 kernel under each split count
    python3 scripts/bench_flash_fwd.py --trace    # SM clocks per phase of the k loop

Plan variants: at every bf16 row of `chip_smoke.FWD_SHAPES`, the kernel with
one and with two warpgroups per block (two splitting the block's key tiles),
each variant's O and LSE checked against the plain version (chip_smoke's
limits) and graph-timed as chip_smoke does, SDPA's forward beside them.

fp32: at every fp32 row of `chip_smoke.FWD_SHAPES` and `CROSS_SHAPES`, the
fp32 kernel with its key loop split 1, 2, 3, 4 and 8 ways and the planner's
(up to one split per key tile), each with its merge, checked and
graph-timed the same way.  The planner's rule (`f32_bwd_splits`, shared with
the backward) is held against these numbers.

Trace: csrc/flash_fwd.cu is built with JIG_FLASH_TRACE = 1, whose kernel
sums, in thread 0 of each warpgroup, the SM clocks (clock64) spent in each
phase of its k loop; one launch at the planner's plan at every bf16 row of
`chip_smoke.FWD_SHAPES` prints the mean clocks per loop iteration of each
phase, over every warpgroup of the grid.

Prints one line per variant with the card's name and power limit.  Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as smoke  # noqa: E402
from bench_flash_bwd import profiling_builds  # noqa: E402
from jointimagegeneration_torch.ops import flash_attention as flash  # noqa: E402

PHASES = ["stage wait", "barrier and refill issue", "S", "max, rescale and P", "O += P V and wait"]


def variant(plan: flash.FlashFwdPlan, wg: int) -> flash.FlashFwdPlan:
    """The plan with `wg` warpgroups per block."""
    return dataclasses.replace(plan, warpgroups=wg, threads=128 * wg,
                               smem_bytes=flash._fwd_smem(plan.head_width, wg))


def run(q, k, v, plan):
    """One launch of the forward kernel on `plan` (in fp32 with its merge
    where the plan splits the key loop): (O, LSE)."""
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[1], 1), dtype=torch.float32, device=q.device)
    ws_o = ws_ml = None
    if plan.splits > 1:
        ws_o = torch.empty((plan.splits, *q.shape), dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((plan.splits, q.shape[0], q.shape[1], 2), dtype=torch.float32, device=q.device)
    flash._launch("jig_flash_fwd", (q, k, v, o, lse, ws_o, ws_ml), q, k, plan)
    if ws_o is not None:
        flash.flash_fwd_merge(ws_o, ws_ml, o, lse)
    return o, lse


def bench_fp32(card: str) -> None:
    """The fp32 kernel under each split count at the fp32 main-path rows."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(4)
    for (bh, tq, tk, d), dtype, where in smoke._full_shapes(smoke.FWD_SHAPES):
        if dtype != torch.float32:
            continue
        q = torch.randn(bh, tq, d, generator=g, device="cuda") / d ** 0.5
        k, v = (torch.randn(bh, tk, d, generator=g, device="cuda") for _ in range(2))
        want_o, want_lse = flash.flash_attention_plain(q, k, v)
        base = flash.plan_flash_fwd(bh, tq, tk, d, dtype)
        lib_ms, _ = smoke.time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=1.0), 50)
        for splits in sorted({1, 2, 3, 4, 8, base.splits}):
            if splits > -(-tk // base.rows):
                continue
            plan = dataclasses.replace(base, splits=splits, grid=base.grid // base.splits * splits)
            o, lse = run(q, k, v, plan)
            torch.cuda.synchronize()
            err_o = (o - want_o).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            smoke.check(err_o <= smoke.O_REL_TOL[dtype] * want_o.abs().max().item() and err_lse <= smoke.LSE_TOL,
                        f"fp32 {(bh, tq, tk, d)} with {splits} splits: O {err_o}, LSE {err_lse}")
            ms, _ = smoke.time_ms(lambda: run(q, k, v, plan), 50)
            mark = " (the plan's)" if splits == base.splits else ""
            print(f"flash_fwd fp32 plan {[bh, tq, tk, d]} ({where}): {splits} splits{mark}, {plan.grid} blocks: "
                  f"{ms:.4f} ms with the merge (sdpa {lib_ms:.4f}); err O {err_o:.3g} LSE {err_lse:.3g}; card {card}",
                  flush=True)
        del q, k, v, want_o, want_lse
        torch.cuda.empty_cache()


def bf16_inputs(g, bh, t, d):
    q = (torch.randn(bh, t, d, generator=g, device="cuda") / d ** 0.5).to(torch.bfloat16)
    k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2))
    return q, k, v


def trace(card: str) -> None:
    cdll, table = profiling_builds({"trace": "JIG_FLASH_TRACE=1"}, flash.FLASH_SOURCE)["trace"]
    set_trace = cdll.jig_flash_fwd_trace
    set_trace.argtypes = [ctypes.c_void_p]
    real = flash._kernel_fn
    g = torch.Generator(device="cuda").manual_seed(5)
    for (bh, t, d), dtype, where in smoke.FWD_SHAPES:
        if dtype != torch.bfloat16:
            continue
        q, k, v = bf16_inputs(g, bh, t, d)
        plan = flash.plan_flash_fwd(bh, t, t, d, dtype)
        buf = torch.zeros((plan.grid * plan.warpgroups, 7), dtype=torch.int64, device="cuda")
        flash._kernel_fn = table.__getitem__
        try:
            smoke.check(set_trace(buf.data_ptr()) == 0, "jig_flash_fwd_trace failed")
            run(q, k, v, plan)
            torch.cuda.synchronize()
        finally:
            flash._kernel_fn = real
        iters = plan.grid * (-(-t // flash.TILE))  # every block walks every key tile
        per = (buf[:, :len(PHASES)].sum(dim=0).double() / iters).tolist()
        parts = ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, per))
        print(f"flash_fwd trace {[bh, t, t, d]} ({where}; {plan.warpgroups} warpgroup(s) per block): SM clocks "
              f"per iteration of one warpgroup: {parts}; total {sum(per):.0f}; card {card}", flush=True)
        del q, k, v, buf
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_flash_fwd: needs a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    card = smoke.card_line()
    if sys.argv[1:] == ["--trace"]:
        trace(card)
        return 0
    if sys.argv[1:] == ["--fp32"]:
        bench_fp32(card)
        return 0
    g = torch.Generator(device="cuda").manual_seed(3)
    for (bh, t, d), dtype, where in smoke.FWD_SHAPES:
        if dtype != torch.bfloat16:
            continue
        q, k, v = bf16_inputs(g, bh, t, d)
        want_o, want_lse = flash.flash_attention_plain(q, k, v)
        base = flash.plan_flash_fwd(bh, t, t, d, dtype)
        lib_ms, _ = smoke.time_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=1.0), 50)
        for wg in (1, 2):
            plan = variant(base, wg)
            o, lse = run(q, k, v, plan)
            torch.cuda.synchronize()
            err_o = (o.float() - want_o.float()).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            smoke.check(err_o <= smoke.O_REL_TOL[dtype] * want_o.float().abs().max().item()
                        and err_lse <= smoke.LSE_TOL, f"{(bh, t, d)} with {wg} warpgroups: O {err_o}, LSE {err_lse}")
            ms, _ = smoke.time_ms(lambda: run(q, k, v, plan), 50)
            mark = " (the plan's)" if wg == base.warpgroups else ""
            print(f"flash_fwd plan {[bh, t, t, d]} ({where}): {wg} warpgroup(s) per block{mark}, {plan.grid} "
                  f"blocks: {ms:.4f} ms (sdpa {lib_ms:.4f}); err O {err_o:.3g} LSE {err_lse:.3g}; card {card}",
                  flush=True)
        del q, k, v, want_o, want_lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
