"""Training metrics: JSONL scalars, PNG panels, TensorBoard, a throughput counter,
device memory, and the profiler trace's summary.

Counterpart of `jointimagegeneration_tpu/core/logging.py`:
`MetricLogger.scalars` appends one JSON record per call to
`<logdir>/metrics.jsonl` and, where `tensorboardX` (or else
`torch.utils.tensorboard`) imports, writes the scalars as TensorBoard events
under `<logdir>`; `MetricLogger.image` writes a panel to `<logdir>/images/`
(the newest 30 kept) and to TensorBoard.  A TensorBoard writer that cannot be
built or fails is dropped, never raised; the JSONL is always written.
`wandb_project` mirrors the scalars to W&B, imported only when asked for.
`Throughput` counts images per second, `hbm_stats` reads the card's memory
watermarks, and `summarize_trace` sums a `torch.profiler` trace's device
kernels by kind (`TRACE_KINDS`, the kinds `scripts/profile_torch_path.py`
reports), the counterpart of the JAX function over an XLA trace.

The span recorder: `span(name, card=False)` marks a region of the program
(a sampler step, a UNet call and its blocks, the text refiner, the hand-off;
the names are listed in `README.md`).  It is on while a `torch.profiler` is
recording (`torch._C._autograd._profiler_enabled()`: a benchmark's traced
segment, a trainer's `profile_steps` window) and while an operator asked for
it (`trace_spans(True)`: `cli/sample.py`'s `trace_spans: true`,
`cli/serve.py`'s `trace_spans=1`).  Off, a span is one flag check: it reads
no clock, allocates nothing and records nothing.  On, it records its host
open and close in ns on `time.time_ns`, the Unix-time clock that
`torch.profiler`'s events carry (its CPU operators here, and on an H100 the
card's kernels, which the profiler converts to the same clock: a card span
around a kernel reads 37-42 us before the profiler's interval of it at both
ends, `chip_smoke.py`'s tracing phase).  A span opened with `card=True` also
records a CUDA event at its close, on the current stream (the one the
session began on); its card open is the recorder's previous event, the close
of the span before it or, for a first child, its parent's open, so the card
work the host issued between two spans counts to the later one (one event a
span: an event record costs the host ~3.4 us on an H100's host, and two a
span would take a UNet call's 48 spans past 1% of a step).  The events come
from a pool: `records()` turns them into host-clock ns (a reference event's
time plus their elapsed time) and hands them back, as a session's end does,
so a session reuses what earlier ones made, and nothing synchronises or reads
an event on the hot path (reading one costs ~7.5 us).  A session begins with
the first span after the recorder turns on: one synchronise and the
reference event, whose host time is read between the last host read at
which the card had not passed it and the first at which it had.  Each
record is (name, depth, host_open, host_close, card_open, card_close); the
card times are None on a CPU run and where the caller passes `card=False`
(the UNet on a sharded 'model' axis).  What a session recorded
stays readable until the next one begins or `reset_spans()`.
Inside `spans_paused()` (a CUDA graph's capture, `nn/graphed.py`) no span
records.  `intervals()` flattens the records into the innermost span open at each
instant, (start ns, end ns, name), the form `perfbench.trace.reduce_events`
attributes the card's idle gaps to.  `timed_span` is a span whose handle also
keeps its host seconds when the recorder is off (a served request's
timings); `span_summary` sums records by name (count, mean issue and card ms).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import re
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..eval.writers import save_grid_png

__all__ = ["MetricLogger", "Throughput", "hbm_stats", "summarize_trace", "TRACE_KINDS", "kind_of", "span",
           "timed_span", "records", "intervals", "trace_spans", "reset_spans", "span_summary", "span_table",
           "print_span_summary", "SpanRecord", "spans_paused"]

TRACE_KINDS = [  # (kind, pattern on the kernel name), first match wins
    ("conv3d_kernel", r"conv3d_wgmma_kernel|conv3d_ffma_kernel|splitk_reduce_kernel|stats_reduce_kernel"),
    ("flash_fwd", r"flash_fwd"),
    ("flash_bwd", r"flash_bwd|delta_f32_kernel|splits_reduce_f32_kernel"),
    ("optimizer", r"multi_tensor_apply|foreach|adam"),
    ("conv", r"xmma_fprop|implicit_gemm|conv|cudnn|wgrad|dgrad"),
    ("matmul", r"gemm|cutlass|cublas"),
    ("norm_reduce", r"reduce_kernel|welford"),
    ("copy_cast", r"copy_kernel|catarray|cat_batched"),
    ("elementwise", r"elementwise|silu|softmax|index"),
]


def kind_of(name: str) -> str:
    for kind, pat in TRACE_KINDS:
        if re.search(pat, name, re.IGNORECASE):
            return kind
    return "other"


def _tensorboard_writer(logdir: Path):
    for module in ("tensorboardX", "torch.utils.tensorboard"):
        try:
            return __import__(module, fromlist=["SummaryWriter"]).SummaryWriter(str(logdir))
        except Exception:
            continue
    return None


class MetricLogger:
    def __init__(self, logdir, wandb_project: Optional[str] = None, wandb_mode: str = "offline"):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        # the PNG trail, oldest first (equal times by name, so by step within
        # a panel), seeded from disk so that the bound holds per run
        # directory across resumes
        self._pngs = sorted((self.logdir / "images").glob("*.png"), key=lambda p: (p.stat().st_mtime, p.name))
        self._tb = _tensorboard_writer(self.logdir)
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, mode=wandb_mode, dir=str(self.logdir))
            except Exception:
                self._wandb = None

    max_images = 30  # PNGs kept under images/; the oldest is unlinked

    def _to_tb(self, fn: str, *args, **kw) -> None:
        if self._tb is not None:
            try:
                getattr(self._tb, fn)(*args, **kw)
            except Exception:
                self._tb = None  # the JSONL and PNGs stay authoritative

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step), **{f"{prefix}{k}": float(v) for k, v in values.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        for name, v in rec.items():
            if name != "step":
                self._to_tb("add_scalar", name, v, int(step))
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "step"}, step=int(step))

    def image(self, step: int, name: str, img: np.ndarray) -> None:
        """Write `img` ((H, W, 3) uint8) as `images/<name>_gs-<step>.png`, '/'
        in the name as '_'; past `max_images` files the oldest goes."""
        path = self.logdir / "images" / f"{name.replace('/', '_')}_gs-{int(step):06d}.png"
        save_grid_png(path, img)
        self._to_tb("add_image", name, np.asarray(img), int(step), dataformats="HWC")
        if path in self._pngs:  # the same (name, step) again overwrote one file
            self._pngs.remove(path)
        self._pngs.append(path)
        while len(self._pngs) > self.max_images:
            self._pngs.pop(0).unlink(missing_ok=True)

    def close(self) -> None:
        self._jsonl.close()
        self._to_tb("close")


class Throughput:
    """Images per second since the last `reset`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._n = 0

    def update(self, n: int) -> None:
        self._n += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._n / dt if dt > 0 else 0.0


def hbm_stats(device: torch.device) -> Dict[str, float]:
    """{hbm_peak_gib: torch.cuda.max_memory_allocated, hbm_reserved_gib:
    torch.cuda.memory_reserved} in GiB on a CUDA device; {} elsewhere."""
    if device.type != "cuda":
        return {}
    return {"hbm_peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "hbm_reserved_gib": torch.cuda.memory_reserved(device) / 2**30}


def summarize_trace(trace, top_k: int = 20, group: str = "category") -> List[Tuple[str, float, int]]:
    """[(key, total ms, count)], longest first, of the device kernels in a
    `torch.profiler` chrome trace: a `.json` (or `.json.gz`) file, or a
    directory holding them (the newest).
    `group` "category" sums by `TRACE_KINDS`, "name" by kernel name.  A trace
    with no device kernel (a CPU run) is summed over its top-level CPU ops,
    keyed "cpu:<op>"."""
    path = Path(trace)
    if path.is_dir():
        files = sorted(glob.glob(str(path / "**" / "*.json*"), recursive=True), key=lambda f: Path(f).stat().st_mtime)
        if not files:
            return []
        path = Path(files[-1])
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        raw = json.load(f).get("traceEvents", [])
    cpu = [e for e in raw if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    tops = []  # the CPU ops no other op of the same thread encloses
    for tid in {e.get("tid") for e in cpu}:
        end = -1.0
        for e in sorted((e for e in cpu if e.get("tid") == tid), key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                tops.append(e)
                end = e["ts"] + e["dur"]
    events = [(e["name"], float(e["dur"]), True) for e in raw
              if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    events += [(e["name"], float(e["dur"]), False) for e in tops]
    on_device = any(dev for _, _, dev in events)
    agg: Dict[str, list] = {}
    for name, us, dev in events:
        if dev != on_device:
            continue
        key = (kind_of(name) if group == "category" else name) if dev else f"cpu:{name}"
        row = agg.setdefault(key, [0.0, 0])
        row[0] += us / 1e3
        row[1] += 1
    return sorted(((k, ms, n) for k, (ms, n) in agg.items()), key=lambda r: -r[1])[:top_k]


# -- the span recorder ---------------------------------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled
_time_ns = time.time_ns


class SpanRecord(NamedTuple):
    name: str
    depth: int
    host_open: int  # ns, time.time_ns
    host_close: int
    card_open: Optional[int]  # ns on the same clock; None without card events
    card_close: Optional[int]


class _Recorder:
    """The session's closed spans as rows (name, depth, host open, host
    close, card open, card close), the card times as indices into `events`,
    the session's CUDA events in the order they were recorded (-1: the
    reference); `times` holds the ns of those already read."""

    def __init__(self):
        self.forced = False
        self.live = False
        self.paused = 0
        self.session = 0
        self.cuda = False
        self.stream = None
        self.ref = None
        self.ref_ns = 0
        self.rows: list = []
        self.open: list = []
        self.events: list = []
        self.times: list = []
        self.last = -1
        self.free: list = []

    def start(self) -> None:
        """A new session: on the card, the host time of a reference event,
        which the card passes as soon as it is recorded (the stream is
        drained first): between the last host read at which it had not been
        passed and the first at which it had."""
        self.end()
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self.cuda:
            self.stream = torch.cuda.current_stream()
            torch.cuda.synchronize()
            if self.ref is None:
                self.ref = torch.cuda.Event(enable_timing=True)
            lo = _time_ns()
            self.ref.record(self.stream)
            while not self.ref.query():
                lo = _time_ns()
            self.ref_ns = (lo + _time_ns()) // 2
        self.live = True

    def end(self) -> None:
        """Drop what the last session recorded; its events go back to the pool."""
        self.free += [ev for ev in self.events if ev is not None]
        self.rows, self.open, self.events, self.times, self.last, self.live = [], [], [], [], -1, False
        self.session += 1  # a span still open from it records nothing

    def event(self) -> int:
        """Record an event from the pool; its index."""
        ev = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.events.append(ev)
        self.last = len(self.events) - 1
        return self.last

    def read(self) -> None:
        """The ns of the events not read yet, once the card has passed them;
        the events go back to the pool."""
        events, times = self.events, self.times
        if len(times) == len(events):
            return
        events[-1].synchronize()
        elapsed, ref_ns = self.ref.elapsed_time, self.ref_ns
        for i in range(len(times), len(events)):
            times.append(ref_ns + round(elapsed(events[i]) * 1e6))
            self.free.append(events[i])
            events[i] = None

    def card_ns(self, i: Optional[int]) -> Optional[int]:
        return None if i is None else self.ref_ns if i < 0 else self.times[i]


_REC = _Recorder()


class _Off:
    """A span while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """An open span; its row is kept at its close.  A card span's open is
    the recorder's last event (the reference at a session's start), and
    its close an event of its own."""

    __slots__ = ("name", "card", "depth", "session", "c0", "t0", "t1")

    def __init__(self, name: str, card: bool):
        self.name, self.card, self.t1 = name, card, None

    def __enter__(self):
        rec = _REC
        if not rec.live:
            rec.start()
        stack = rec.open
        self.depth, self.session = len(stack), rec.session
        stack.append(self)
        self.c0 = rec.last if self.card and rec.cuda else None
        self.t0 = _time_ns()
        return self

    def __exit__(self, *exc):
        rec = _REC
        if self.session != rec.session:
            self.t1 = _time_ns()
            return False
        c0 = self.c0
        c1 = None if c0 is None else rec.event()
        self.t1 = t1 = _time_ns()
        rec.rows.append((self.name, self.depth, self.t0, t1, c0, c1))
        stack = rec.open
        if stack and stack[-1] is self:
            stack.pop()
        return False

    @property
    def seconds(self) -> float:
        """Host seconds from the open to the close (to now while open)."""
        return ((self.t1 or _time_ns()) - self.t0) / 1e9


class _Clock:
    """A timed span while the recorder is off: its host seconds alone."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0, self.t1 = _time_ns(), None
        return self

    def __exit__(self, *exc):
        self.t1 = _time_ns()
        return False

    seconds = _Span.seconds


def span(name: str, card: bool = False):
    """A context marking `name` while the recorder is on (see the module's
    docstring); with `card`, CUDA events at its open and close too."""
    if not (_REC.forced or _profiler_enabled()):
        _REC.live = False
        return _OFF
    return _OFF if _REC.paused else _Span(name, card)


def timed_span(name: str, card: bool = False):
    """`span`, whose handle keeps its host `seconds` even with the recorder off."""
    if not (_REC.forced or _profiler_enabled()):
        _REC.live = False
        return _Clock()
    return _Clock() if _REC.paused else _Span(name, card)


@contextlib.contextmanager
def spans_paused():
    """No span records inside: a CUDA graph's capture, whose calls run no
    kernels and may place no event on the capturing stream."""
    _REC.paused += 1
    try:
        yield
    finally:
        _REC.paused -= 1


def trace_spans(on: bool) -> None:
    """Keep the recorder on (or no longer) outside a profiler's window."""
    _REC.forced = bool(on)
    if not on:
        _REC.live = False


def reset_spans() -> None:
    """Drop what the recorder holds; the next span begins a new session."""
    _REC.end()


def records() -> List[SpanRecord]:
    """The current (or last) session's closed spans, in opening order, every
    card time in host-clock ns (waiting for the card once, where it has not
    passed them yet)."""
    rec = _REC
    rec.read()
    return [SpanRecord(name, depth, h0, h1, rec.card_ns(c0), rec.card_ns(c1))
            for name, depth, h0, h1, c0, c1 in sorted(rec.rows, key=lambda row: (row[2], row[1]))]


def intervals(recs: Optional[List[SpanRecord]] = None) -> List[Tuple[int, int, str]]:
    """[(start ns, end ns, name)] of the innermost span open at each instant
    on the host, in time order and never overlapping: a span's own time
    outside its children is its own pieces."""
    out: List[Tuple[int, int, str]] = []
    stack: list = []  # [name, cursor, close]

    def pop():
        name, cursor, close = stack.pop()
        if close > cursor:
            out.append((cursor, close, name))
        if stack:
            stack[-1][1] = max(stack[-1][1], close)

    for r in records() if recs is None else recs:
        while stack and stack[-1][2] <= r.host_open:
            pop()
        if stack and r.host_open > stack[-1][1]:
            out.append((stack[-1][1], r.host_open, stack[-1][0]))
        stack.append([r.name, r.host_open, r.host_close])
    while stack:
        pop()
    return out


def span_summary(recs: List[SpanRecord], totals: Optional[dict] = None) -> Dict[str, list]:
    """{name: [count, host ns, card count, card ns]} of `recs`, added into
    `totals` where given."""
    totals = {} if totals is None else totals
    for r in recs:
        t = totals.setdefault(r.name, [0, 0, 0, 0])
        t[0] += 1
        t[1] += r.host_close - r.host_open
        if r.card_open is not None:
            t[2] += 1
            t[3] += r.card_close - r.card_open
    return totals


def span_table(totals: Dict[str, list]) -> Dict[str, dict]:
    """{name: {"count", "issue_ms", "card_ms"}} (means; card_ms None without
    card times) of `span_summary`'s totals."""
    return {name: {"count": n, "issue_ms": host / n / 1e6, "card_ms": card / nc / 1e6 if nc else None}
            for name, (n, host, nc, card) in totals.items()}


def print_span_summary(totals: Dict[str, list], title: str = "spans") -> None:
    """One line per span name: count, mean issue ms, mean card ms."""
    print(f"{title}: count, mean issue ms, mean card ms")
    for name, row in sorted(span_table(totals).items(), key=lambda kv: -kv[1]["count"] * kv[1]["issue_ms"]):
        card = "-" if row["card_ms"] is None else f"{row['card_ms']:9.3f}"
        print(f"  {name:<28s} {row['count']:7d} {row['issue_ms']:9.3f} {card}")
