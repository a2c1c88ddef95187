"""What the per-layer metrics read, shared by the readers under
`perfbench/layer_metrics/` (one file per metric, found by its name).

Each function takes the finished `harness.Run` and returns a number, or None
where the run has nothing to read (the harness then leaves the metric out).
Shares are in percent and are never clipped: a share above 100 means that
the operations or bytes are counted too high, or the time misses work.
"""

from __future__ import annotations

import statistics
import sys
from typing import Optional

from .counts import PEAK_BF16_FLOPS, flash_bwd_roofline_s, flash_fwd_roofline_s, flash_sites, refiner_flash_sites

__all__ = ["unet_host_ms", "loader_wait_ms", "norm_elementwise_ms", "optimizer_ms", "flash_roofline", "mfu",
           "device_idle_share"]

NORM_ELEMENTWISE = ("elementwise", "norm_reduce", "copy_cast")


def _window_mean_ms(run, span: str) -> Optional[float]:
    times = run.spans.phases["window"].get(span)
    return 1e3 * statistics.fmean(times) if times else None


def unet_host_ms(run) -> Optional[float]:
    """Mean host ms from a UNet forward's pre-hook to its post-hook, over the
    window: the time to issue a forward where the host sets the pace, near
    the device's time where the card does."""
    return _window_mean_ms(run, "unet")


def loader_wait_ms(run) -> Optional[float]:
    """Mean host ms a train step waited for the loader's next batch, over the
    window."""
    return _window_mean_ms(run, "loader_wait")


def _per_unit(run, seconds: float) -> Optional[float]:
    """Device ms per UNet call (per train step, where each unit runs the
    backward) in the profiled segment."""
    if run.unet_backward:
        n = run.traced_work
    else:
        n = len(run.spans.phases["traced"].get("unet", ()))
    return 1e3 * seconds / n if n else None


def norm_elementwise_ms(run) -> Optional[float]:
    """Device ms of the elementwise, norm-reduction and copy/cast kernels."""
    if run.profile is None or not any(k in run.profile.by_kind for k in NORM_ELEMENTWISE):
        return None
    return _per_unit(run, sum(run.profile.by_kind.get(k, 0.0) for k in NORM_ELEMENTWISE))


def optimizer_ms(run) -> Optional[float]:
    """Device ms of the optimizer kind (AdamW and the EMA's foreach ops)."""
    if run.profile is None or "optimizer" not in run.profile.by_kind:
        return None
    return _per_unit(run, run.profile.by_kind["optimizer"])


def flash_roofline(run) -> Optional[float]:
    """Sum over the segment's flash launches of each one's roofline time,
    from the shapes of the UNet's attention sites (self- and, with a text
    context, cross-attention; the text refiner's fp32 self-attention at the
    fp32 peak), over the traced device time of the flash kernels; in
    percent.  None where the program's own launch counters disagree with the
    count of sites."""
    if run.profile is None or run.unet_shape is None:
        return None
    batch, spatial = run.unet_shape
    sites = flash_sites(run.config, batch, spatial, run.context_tokens)
    enc = run.config.get("feature_cond_encoder")
    refiner = refiner_flash_sites(enc, batch, run.context_tokens) if run.context_tokens else []
    traced = run.spans.phases["traced"]
    calls, refines = len(traced.get("unet", ())), len(traced.get("refiner", ()))
    steps = run.traced_work if run.unet_backward else 0
    expected = {"flash_forward": calls * len(sites) + refines * len(refiner), "flash_bwd_dq": steps * len(sites),
                "flash_bwd_dkv": steps * len(sites)}
    if run.counters != expected:
        print(f"flash_roofline: the program counted {run.counters} launches, the sites give {expected}",
              file=sys.stderr)
        return None
    kernel_s = run.profile.by_kind.get("flash_fwd", 0.0) + run.profile.by_kind.get("flash_bwd", 0.0)
    bound = (calls * sum(flash_fwd_roofline_s(*s) for s in sites)
             + refines * sum(flash_fwd_roofline_s(*s, fp32=True) for s in refiner)
             + steps * sum(flash_bwd_roofline_s(*s) for s in sites))
    return 100.0 * bound / kernel_s if kernel_s > 0 and bound > 0 else None


def mfu(run) -> Optional[float]:
    """Model FLOPs of the window's work over the window, as a percent of the
    card's bf16 peak."""
    if not run.flops_per_work or not run.window_s > 0:
        return None
    return 100.0 * run.flops_per_work * run.work / run.window_s / PEAK_BF16_FLOPS


def device_idle_share(run) -> Optional[float]:
    """Percent of the profiled segment in which no kernel or copy ran."""
    if run.profile is None or run.profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
