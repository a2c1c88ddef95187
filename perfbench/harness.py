"""One run of one cell of the port's benchmark.

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
finds, by the names in `BENCHMARK.json`:
  * the cell's configuration, `perfbench/configs/<config>.json`;
  * its traffic, `perfbench/workloads/<cell>.json`, which names its traffic
    module (`perfbench/drivers/<kind>.py`), the end-to-end rate its work
    counts towards, its parameters and the limits of its comparison;
  * each per-layer metric's reader, `perfbench/layer_metrics/<metric>.py`,
    or the file of its first part, which every `<metric>.<suffix>` shares.
So a later cell, configuration, traffic kind or metric is new files and new
entries, and no file here changes.

A run: set-up (the traffic module builds the program on the card, loads the
seeded weights and warms up the cell's shapes), then a window of `--seconds`:
whole units of work are issued until the time has passed, and the window
closes when the card has finished them.  `setup_s` runs from the process's
start to the end of the warm-up; `build_s`, printed beside it, is the part of
it that the program spent building its native libraries, which only a
checkout's first run does.  With `--trace 1` a short profiled segment
follows the window.  Then the program's state is freed and what the window
produced is compared with the plain reference, in exact fp32.  The last line of
standard output is the result; the numbers compared, each beside its limit,
close standard error and the result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ROOT", "Run", "Spans", "load_part", "load_json", "prepare", "execute", "result_line", "main", "stream_seed",
           "FORBIDDEN", "compare", "failures", "build_clock"]

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "jointimagegeneration_tpu")


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one named stream of draws (weights, labels, noise of
    volume v, ...), derived from the run's seed."""
    words = [seed % 2**32, seed >> 32] + [sum(ord(ch) << (8 * (i % 3)) for i, ch in enumerate(str(s))) for s in stream]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def load_part(kind: str, name: str) -> ModuleType:
    """`perfbench/<kind>/<name>.py` as a module; for a dotted name without a
    file of its own, the file of its first part (`mfu.train` is read by
    `mfu.py`, which every `mfu.<suffix>` shares)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        path = HERE / kind / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} file for {name!r} under {(HERE / kind).relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


class Spans:
    """Host-clock spans around calls into the program, by name."""

    def __init__(self):
        self.phases: Dict[str, Dict[str, List[float]]] = {"window": defaultdict(list), "traced": defaultdict(list)}
        self.times = self.phases["window"]
        self.intervals: Optional[List[tuple]] = None  # (start ns, end ns, name) on the wall clock, when kept

    def in_phase(self, phase: str, intervals: bool = False) -> None:
        """Record later spans under `phase` ('window' or 'traced'); with
        `intervals`, also their wall-clock intervals, which the profiled
        segment lines up with the card's timeline."""
        self.times = self.phases[phase]
        self.intervals = [] if intervals else None

    def _open(self, name):
        return time.perf_counter(), time.time_ns()

    def _close(self, name, opened):
        t0, wall0 = opened
        self.times[name].append(time.perf_counter() - t0)
        if self.intervals is not None:
            self.intervals.append((wall0, time.time_ns(), name))

    @contextlib.contextmanager
    def span(self, name: str):
        opened = self._open(name)
        try:
            yield
        finally:
            self._close(name, opened)

    def hook(self, module, name: str) -> list:
        """Spans from `module`'s forward pre-hook to its post-hook; returns
        the handles.  Calls nest: a span per call, closed in order."""
        stack = []

        def pre(_m, _args):
            stack.append(self._open(name))

        def post(_m, _args, _out):
            self._close(name, stack.pop())

        return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]


class Run:
    """What a driver builds and a reader reads.  A driver sets, in `setup`:
    `flops_per_work` (model FLOPs of one unit of the rate), and where the
    cell's readers need them `unet_shape` ((batch, spatial) of its UNet
    calls), `unet_backward` (whether each unit runs the backward too) and
    `context_tokens` (the length of a text context the UNet cross-attends
    over, refined by a text refiner whose calls the spans name 'refiner')."""

    def __init__(self, cell: dict, config: dict, workload: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.config, self.workload = cell, config, workload
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.t_start = t_start
        self.state: dict = {}
        self.spans = Spans()
        self.flops_per_work: Optional[float] = None
        self.unet_shape = None
        self.unet_backward = False
        self.context_tokens: Optional[int] = None
        self.work = 0
        self.window_s = math.nan
        self.setup_s = math.nan
        self.build_s = 0.0
        self.profile = None  # trace.Profile of the segment
        self.traced_work = 0
        self.counters: Dict[str, int] = {}
        self.memory_peak_bytes = 0

    def seed_of(self, *stream) -> int:
        return stream_seed(self.seed, *stream)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def program_counters() -> Dict[str, int]:
    """The program's own launch counters of its flash kernels."""
    from jointimagegeneration_torch.ops import flash_attention as fa

    return {name: getattr(fa, name).launches for name in ("flash_forward", "flash_bwd_dq", "flash_bwd_dkv")}


def window_context(driver: ModuleType, run: Run):
    """The context the window runs in (the traffic module's `window_context`, or none)."""
    return getattr(driver, "window_context", lambda _run: contextlib.nullcontext())(run)


def window(run: Run, driver: ModuleType) -> None:
    """Issue whole units until `run.seconds` have passed; the window closes
    when the card has finished them."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        run.work += driver.step(run)
    run.sync()
    run.window_s = time.perf_counter() - t0


@contextlib.contextmanager
def build_clock(run: Run):
    """Adds to `run.build_s` the seconds spent in the program's builds of its
    native libraries (`ops/cuda/build.build_all`, which compiles only where
    a checkout has no library yet)."""
    from jointimagegeneration_torch.ops.cuda import build

    build_all = build.build_all

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return build_all(*args, **kw)
        finally:
            run.build_s += time.perf_counter() - t0

    build.build_all = timed
    try:
        yield
    finally:
        build.build_all = build_all


def compare(run: Run, driver: ModuleType, control: bool = False):
    """(readings, [(name, value, limit)]) of the comparison: the traffic
    module's readings (with `control`, the control's in the program's place),
    the references computing in exact fp32, and each number under a limit of
    the workload beside its limit."""
    from .reference import exact_fp32

    with exact_fp32():
        got = driver.readings(run, control=control)
    return got, [(name, got[name], limit) for name, limit in run.workload["limits"].items()]


def failures(checks: List[tuple]) -> int:
    """How many numbers are not within their limits (a missing reading, NaN,
    fails)."""
    return sum(1 for _, value, limit in checks if not value <= limit)


def execute(run: Run, driver: ModuleType, readers: Dict[str, tuple], e2e: List[tuple]) -> dict:
    """Set-up, window, optional profiled segment and the comparison; returns
    the result object (without `device`)."""
    import torch

    with build_clock(run):
        driver.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - run.t_start
    with window_context(driver, run):
        window(run, driver)
        if run.trace:
            from . import trace

            before = program_counters()
            run.spans.in_phase("traced", intervals=True)
            run.profile, run.traced_work = trace.profile_segment(run, lambda: driver.traced(run))
            run.spans.in_phase("window")
            after = program_counters()
            run.counters = {k: after[k] - before[k] for k in after}
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    driver.release(run)
    _, checks = compare(run, driver)
    failed = failures(checks)
    result = {"correct": failed == 0, "attempted": run.work, "failed": failed}
    if run.trace:
        metrics = {}
        for name, (unit, read) in readers.items():
            value = read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
        result["metrics"] = metrics
        result["breakdown"] = run.profile.breakdown
    else:
        values = {"setup_s": run.setup_s, run.workload["rate_metric"]: run.work / run.window_s}
        result["metrics"] = {name: {"value": values[name], "unit": unit} for name, unit in e2e}
    result["build_s"] = run.build_s  # inside setup_s: a run whose checkout had its libraries reads ~0
    # a reading that could not be taken (inf) is printed as null: the line stays strict JSON
    result["checks"] = {name: {"value": value if math.isfinite(value) else None, "limit": limit}
                        for name, value, limit in checks}
    return result


def cell_metrics(bench: dict, cell: str):
    """(end-to-end [(name, unit)], per-layer {name: unit}) that `cell` reports."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"] if applies(m)]
    names = {n for n, _ in e2e}
    layer = {}
    for m in bench["per_layer"]:
        if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names):
            layer[m["name"]] = m["unit"]
    return e2e, layer


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    workload, config, driver, readers, e2e = prepare(bench, args.workload)
    run = Run(cell, config, workload, args.seed, args.seconds, bool(args.trace), device, t_start)
    result = execute(run, driver, readers, e2e)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    print(result_line(run, result, torch.cuda.get_device_name(device)))
    return 0


def prepare(bench: dict, name: str):
    """(workload, config, driver module, {metric: (unit, reader)}, [(end-to-end
    metric, unit)]) of cell `name`, each found by its name."""
    cell = {c["name"]: c for c in bench["workloads"]}[name]
    workload = load_json("workloads", name)
    config = load_json("configs", cell["config"])
    e2e, layer_units = cell_metrics(bench, name)
    readers = {metric: (unit, load_part("layer_metrics", metric).read) for metric, unit in layer_units.items()}
    return workload, config, load_part("drivers", workload["driver"]), readers, e2e


def result_line(run: Run, result: dict, kind: str) -> str:
    """The result's JSON line, with `device`; the numbers compared, each with
    its limit, come last, and close standard error too."""
    result = dict(result)
    result["device"] = {"platform": "gpu", "kind": kind, "count": run.cell["chips"],
                        "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace:
        result["device"].update(busy_s=run.profile.busy_s, window_s=run.profile.window_s)
    checks = result.pop("checks")
    result["checks"] = checks
    print(f"build_s {result.get('build_s', 0.0)!r} (the native libraries' build, inside setup_s)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return json.dumps(result)
