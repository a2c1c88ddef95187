"""The profiled segment of a `--trace 1` run, reduced in memory.

`torch.profiler` records the card's kernels and copies over a few units of
work after the window.  From its raw events (no trace file is written):
  * `busy_s`: the union of the card's kernel, copy and set intervals;
    `window_s`: the segment, from its start to its close after a synchronise;
  * device seconds by kind (`perfbench.kinds`) and by kernel name, summed over
    launches;
  * the card's idle time, by the innermost benchmark span that was open on
    the host when each gap began.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from .kinds import kind_of

__all__ = ["Profile", "profile_segment", "reduce_events"]

@dataclass
class Profile:
    busy_s: float
    window_s: float
    by_kind: Dict[str, float]
    by_name: Dict[str, float]
    idle_by_span: Dict[str, float]

    @property
    def breakdown(self) -> dict:
        kinds = sorted(self.by_kind.items(), key=lambda kv: -kv[1])[:4]
        names = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:6]
        ops = [[f"kind:{k}", s] for k, s in kinds] + [[_short(n), s] for n, s in names]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": ops, "idle_gaps": [[n, s] for n, s in gaps]}


def _short(name: str) -> str:
    """A kernel's name without the namespaces that every ATen kernel shares,
    cut to 120 characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "c10::"):
        name = name.replace(noise, "")
    return name[:120]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce_events(device: List[Tuple[int, int, str]], spans: List[Tuple[int, int, str]],
                  window: Tuple[int, int]) -> Profile:
    """device: (start ns, end ns, kernel name); spans: the host annotations
    (start, end, name); window: the segment's (start, end)."""
    w0, w1 = window
    by_kind: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for s, e, name in device:
        k = kind_of(name)
        by_kind[k] = by_kind.get(k, 0.0) + (e - s) / 1e9
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1])
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        name = "none"
        i = bisect.bisect_right(starts, g0) - 1
        best = None
        for j in range(i, max(i - 256, -1), -1):  # the innermost open span: the latest start covering g0
            s, e, n = spans[j]
            if e > g0:
                best = (s, n)
                break
        if best is not None:
            name = best[1]
        idle[name] = idle.get(name, 0.0) + (g1 - g0) / 1e9
    return Profile(busy_s=sum(e - s for s, e in busy) / 1e9, window_s=(w1 - w0) / 1e9, by_kind=by_kind,
                   by_name=by_name, idle_by_span=idle)


def profile_segment(run, fn: Callable[[], int]) -> Tuple[Profile, int]:
    """Run `fn` (a few units of work; returns their count) under the
    profiler, synchronised at both ends.  Returns (Profile, work).

    Only the card's activity is recorded (no host operators, whose
    recording would slow the host and inflate the idle share); the host's
    side is the benchmark's own spans (`run.spans.intervals`), on the wall
    clock that the profiler's timestamps also use.  Where the card's events
    do not fall inside the segment's wall-clock window, the two clocks
    disagree: the window is then placed at the first event and the idle time
    is not attributed ('unaligned')."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = run.device.type == "cuda"
    run.sync()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        w0 = time.time_ns()
        work = fn()
        run.sync()
        w1 = time.time_ns()
    device = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    spans = list(run.spans.intervals or ())
    slack = 2_000_000  # 2 ms of the clocks' disagreement
    if device and (min(s for s, _, _ in device) < w0 - slack or max(e for _, e, _ in device) > w1 + slack):
        first = min(s for s, _, _ in device)
        spans, (w0, w1) = [(first, first + w1 - w0, "unaligned")], (first, first + w1 - w0)
    return reduce_events(device, spans, (w0, w1)), work
