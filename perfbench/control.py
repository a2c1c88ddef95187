"""Readings that the limits of a cell's comparison are set from, on the card
at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds <n> ... [--seconds <s>] [--fault <name>]

For each seed: the cell's set-up and a short window at its own load, then
the comparison twice, from the same window, each judged by the harness's own
rule against the cell's limits: the program's numbers (the lower readings),
and the control's, the plain reference computed in fp8 put in the program's
place (the upper readings).  With `--fault <name>`, one of the faults of
`perfbench/tests/test_perfbench_faults.py` is planted in the program first
(`ddim_unchanged`, `half_batch`, `slice_altered`, `mask_unchanged`,
`label_altered`, `train_unchanged`, `loss_altered`, `ema_frozen`,
`ema_decay_zero`) and only the faulty program's comparison is read.  One
JSON line per seed, with `correct` for each side.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import pytest
    import torch

    from perfbench import harness
    from perfbench.tests import test_perfbench_faults as faults

    planted = {f.__name__.lstrip("_"): f for _, f in faults.FAULTS}
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", choices=sorted(planted), help="plant this fault in the program and read the "
                                                             "faulty program's comparison alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    monkeypatch = pytest.MonkeyPatch()
    if args.fault:
        planted[args.fault](monkeypatch)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", cell["config"])
    driver = harness.load_part("drivers", workload["driver"])
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        run = harness.Run(cell, config, workload, seed, args.seconds, False, device, time.perf_counter())
        driver.setup(run)
        with harness.window_context(driver, run):
            harness.window(run, driver)
        driver.release(run)
        t1 = time.perf_counter()
        program, checks = harness.compare(run, driver)
        t2 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, "fault": args.fault, "work": run.work,
                "correct": harness.failures(checks) == 0, "program": program, "program_check_s": t2 - t1}
        if not args.fault:
            control, control_checks = harness.compare(run, driver, control=True)
            line.update(control_correct=harness.failures(control_checks) == 0, control=control,
                        control_check_s=time.perf_counter() - t2)
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    monkeypatch.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
