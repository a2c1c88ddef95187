#!/usr/bin/env python3
"""Time the kernel phases of two checkouts of the repo in turns on one NVIDIA
card: the way to compare a change with its parent inside one call.

    git archive <parent> | tar -x -C build/parent     # a git-ignored directory
    python3 scripts/ab_kernel_phases.py build/parent [--phases fwd bwd conv]

Builds both checkouts' kernels (one nvcc per source, all started together),
then runs `chip_smoke.flash_phase`, `chip_smoke.bwd_phase` and/or
`chip_smoke.conv_phase` of the parent, this checkout, this checkout again and
the parent (each turn a process of its own whose working directory is the
checkout, so its package, kernels and phase code are the ones that run), and
prints each row's times per turn: the forward's graph-timed `ms` and its
`eager_ms`, the backward's `dq_ms`, `dkv_ms` and `ms`, and the conv's `ms`.
Rows are matched by their shape, dtype and options, so a row that only one
tree has is printed as such.  The phases check every kernel against its
plain version as chip_smoke.py does, so a turn that disagrees fails.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke as c
from jointimagegeneration_torch.ops import conv3d, flash_attention
out = {}
if "fwd" in sys.argv[1:]:
    rows, _ = c.flash_phase(flash_attention)
    out["fwd"] = [{k: r[k] for k in ("shape", "dtype", "ms", "eager_ms")} for r in rows]
if "bwd" in sys.argv[1:]:
    out["bwd"] = [{k: r[k] for k in ("shape", "dtype", "ms", "dq_ms", "dkv_ms")} for r in c.bwd_phase(flash_attention)]
if "conv" in sys.argv[1:]:
    out["conv"] = [{k: r[k] for k in ("shape", "cout", "options", "dtype", "ms")} for r in c.conv_phase(conv3d)[0]]
print("RESULT " + json.dumps(out), flush=True)
"""

BUILD = r"""
import sys
sys.path.insert(0, ".")
from jointimagegeneration_torch.ops.cuda import build
print(build.build_all(["flash_fwd", "flash_bwd", "conv3d"]), flush=True)
"""


def run_turn(tree: Path, phases) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, *phases], cwd=tree, capture_output=True, text=True)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith("RESULT "):
        raise SystemExit(f"turn in {tree} failed (rc {proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path, help="a checkout of the parent commit")
    ap.add_argument("--phases", nargs="+", default=["fwd", "bwd", "conv"], choices=["fwd", "bwd", "conv"])
    args = ap.parse_args()
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t) for t in trees.values()]
    if any(b.wait() != 0 for b in builds):
        raise SystemExit("a build failed")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    order = ["parent", "change", "change", "parent"]
    results = [run_turn(trees[name], args.phases) for name in order]
    print(f"turns {order} on {card}")
    for phase, keys in (("fwd", ("ms", "eager_ms")), ("bwd", ("dq_ms", "dkv_ms", "ms")), ("conv", ("ms",))):
        if phase not in args.phases:
            continue
        turns = [{json.dumps({k: v for k, v in row.items() if not k.endswith("ms")}): row for row in r[phase]}
                 for r in results]
        labels = list(turns[0]) + [lab for lab in turns[1] if lab not in turns[0]]
        for label in labels:
            for key in keys:
                vals = [t[label][key] if label in t else None for t in turns]
                if None in vals:
                    have = " / ".join("-" if v is None else f"{v:.4f}" for v in vals)
                    print(f"{phase} {label} {key}: {have} ms (parent, change, change, parent); "
                          f"in one tree only", flush=True)
                    continue
                p, c = (vals[0] + vals[3]) / 2, (vals[1] + vals[2]) / 2
                print(f"{phase} {label} {key}: " + " / ".join(f"{v:.4f}" for v in vals)
                      + f" ms (parent, change, change, parent); parent/change {p / c:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
