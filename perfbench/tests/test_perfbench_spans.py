"""The three span readers (`step_card_ms`, `step_issue_ms`,
`card_backlog_ms`) on a synthetic record of the program's span recorder,
and their silence where the program has no recorder or recorded no step."""

from __future__ import annotations

import types

import pytest

from jointimagegeneration_torch.core import logging as program_logging
from perfbench import harness

MS = 1_000_000  # ns
STEPS = [  # (name, depth, host open, host close, card open, card close) in ns
    ("sampler.step", 0, 0, 40 * MS, 1 * MS, 39 * MS),
    ("unet", 1, 1 * MS, 38 * MS, 2 * MS, 38 * MS),
    ("sampler.step", 0, 40 * MS, 82 * MS, 43 * MS, 83 * MS),
    ("sampler.step", 0, 82 * MS, 120 * MS, 82 * MS, 121 * MS),
    ("slice.post", 0, 120 * MS, 121 * MS, 121 * MS, 122 * MS),
]


def _read(metric: str, recs, profile=True):
    run = types.SimpleNamespace(profile=object() if profile else None)
    return harness.load_part("layer_metrics", metric).read(run)


@pytest.fixture
def recorded(monkeypatch):
    def set_records(recs):
        monkeypatch.setattr(program_logging, "records", lambda: [program_logging.SpanRecord(*r) for r in recs])

    return set_records


@pytest.mark.parametrize("suffix", ["slices", "mask"])
def test_readers_of_a_synthetic_record(recorded, suffix):
    recorded(STEPS)
    assert _read(f"step_card_ms.{suffix}", STEPS) == pytest.approx((38 + 40 + 39) / 3)
    assert _read(f"step_issue_ms.{suffix}", STEPS) == pytest.approx((40 + 42 + 38) / 3)
    assert _read(f"card_backlog_ms.{suffix}", STEPS) == pytest.approx(1.0)  # the median of 1, 3 and 0


def test_host_only_steps(recorded):
    """Steps without card times (a sharded 'model' axis, a CPU run): the
    issue is read, the card metrics are not."""
    recs = [("sampler.step", 0, 0, 2 * MS, None, None), ("sampler.step", 0, 2 * MS, 6 * MS, None, None)]
    recorded(recs)
    assert _read("step_issue_ms.slices", recs) == pytest.approx(3.0)
    assert _read("step_card_ms.slices", recs) is None and _read("card_backlog_ms.slices", recs) is None


@pytest.mark.parametrize("metric", ["step_card_ms.mask", "step_issue_ms.mask", "card_backlog_ms.mask"])
def test_nothing_to_read(recorded, monkeypatch, metric):
    recorded([r for r in STEPS if r[0] != "sampler.step"])
    assert _read(metric, STEPS) is None  # no sampler.step
    recorded(STEPS)
    assert _read(metric, STEPS, profile=False) is None  # no traced segment
    monkeypatch.delattr(program_logging, "records")  # a program without the recorder
    assert _read(metric, STEPS) is None
