"""The harness: every part found by its name, a new cell added by files and
entries alone, the result line's form, and what a run imports."""

from __future__ import annotations

import ast
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_part_is_found_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for cell in BENCH["workloads"]:
        assert cell["config"] in names and cell["name"] == f"{cell['config']}.{cell['traffic']}"
        workload, config, driver, readers, e2e = harness.prepare(BENCH, cell["name"])
        for fn in ("setup", "step", "traced", "release", "readings"):
            assert callable(getattr(driver, fn)), (cell["name"], fn)
        assert workload["rate_metric"] in dict(e2e) and "setup_s" in dict(e2e)
        assert readers, cell["name"]
        for metric in BENCH["per_layer"]:
            if cell["name"] in metric["workloads"]:
                assert metric["moves"] in dict(e2e), metric["name"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in e2e
        assert callable(harness.load_part("layer_metrics", metric["name"]).read)


DUMMY_DRIVER = '''
import torch

def setup(run):
    run.flops_per_work = 2.0 * 64 ** 3
    run.state["a"] = torch.randn(64, 64)

def step(run):
    with run.spans.span("matmul"):
        run.state["b"] = run.state["a"] @ run.state["a"]
    return 1

def traced(run):
    return step(run)

def release(run):
    pass

def readings(run, control=False):
    return {"err": float((run.state["b"] - run.state["a"] @ run.state["a"]).abs().max())}
'''

DUMMY_METRIC = '''
import statistics

def read(run):
    times = run.spans.phases["window"].get("matmul")
    return 1e3 * statistics.fmean(times) if times else None
'''


def test_a_cell_is_added_by_files_and_entries(tmp_path, monkeypatch):
    """A new traffic kind, cell, configuration and per-layer metric: files
    under perfbench/ and entries in BENCHMARK.json, no file edited."""
    here = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "drivers" / "matmul.py").write_text(DUMMY_DRIVER)
    (here / "layer_metrics" / "matmul_ms.dummy.py").write_text(DUMMY_METRIC)
    (here / "configs" / "dummy.json").write_text(json.dumps({"reduced": [], "n": 64}))
    (here / "workloads" / "dummy.mm.json").write_text(json.dumps(
        {"driver": "matmul", "rate_metric": "matmuls_per_s", "limits": {"err": 0.0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy", "source": "x", "file": "perfbench/configs/dummy.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "dummy.mm", "config": "dummy", "traffic": "mm", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "matmuls_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["dummy.mm"]})
    bench["per_layer"].append({"name": "matmul_ms.dummy", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "matmuls_per_s", "workloads": ["dummy.mm"]})
    monkeypatch.setattr(harness, "HERE", here)
    workload, config, driver, readers, e2e = harness.prepare(bench, "dummy.mm")
    assert config["n"] == 64 and set(readers) == {"matmul_ms.dummy"}
    assert {n for n, _ in e2e} == {"matmuls_per_s", "setup_s"}
    for trace in (False, True):
        run = harness.Run(bench["workloads"][-1], config, workload, 7, 0.2, trace, torch.device("cpu"), 0.0)
        result = harness.execute(run, driver, readers, e2e)
        assert result["correct"] and result["attempted"] > 0
        assert set(result["metrics"]) == ({"matmul_ms.dummy"} if trace else {"matmuls_per_s", "setup_s"})


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace, capsys):
    run = tiny.tiny_run("slices", trace=trace)
    result = tiny.execute(run)
    line = harness.result_line(run, result, "cpu (test)")
    out = json.loads(line)
    assert list(out)[-1] == "checks" and {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0
    assert 0.0 <= out["build_s"] <= out["metrics"].get("setup_s", {"value": math.inf})["value"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"unet_host_ms.slices", "mfu.slices"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == {"setup_s", "ct_slices_per_s"}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(out["checks"]):] == [f"check {n} {c['value']!r} limit {c['limit']!r}"
                                         for n, c in out["checks"].items()]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN + ("jointimagegeneration_torch",), (path, name)


def test_a_run_loads_no_jax():
    """Every module that the harness, the drivers and the readers load, in a
    process of their own, by whole top-level names."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.tests import tiny\n"
            "from perfbench import harness\n"
            "for kind in tiny.WORKLOADS:\n"
            "    tiny.execute(tiny.tiny_run(kind, trace=True, seconds=0.1))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "jointimagegeneration_torch" in top and "perfbench" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_command_fails_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", BENCH["workloads"][0]["name"],
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_runs_on_the_card():
    """One short run of each cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in BENCH["workloads"]:
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell["name"], "--seed",
                              str(2**31 + 11), "--seconds", "2", "--trace", "0"],
                             capture_output=True, text=True, timeout=1200, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
