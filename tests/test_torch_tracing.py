"""PyTorch port: the span recorder (`core/logging.py`) on the CPU.

Off, a span is the one shared null context and records nothing; on (under a
CPU `torch.profiler`, or with `trace_spans(True)`), the sampler loops, the
UNet and the hand-off record the spans the benchmark's readers and
`scripts/profile_torch_path.py` read, nested as the calls nest, host times
only (no card on the CPU).  The outputs are bit for bit those of the
recorder off.  `intervals()` flattens the records into the innermost span at
each instant; `span_summary` and `span_table` sum them by name."""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jointimagegeneration_torch.core import logging as spans
from jointimagegeneration_torch.diffusion.ddim import DDIMParams
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models.mask_sampler import MaskSampler
from jointimagegeneration_torch.models.slice_ldm import SliceLDM
from jointimagegeneration_torch.pipeline.two_stage import make_chunked_two_stage_programs

UNET = dict(model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
            num_head_channels=4)
REFINER = {"embed_dim": 24, "n_heads": 2, "d_head": 8, "model_depth": 1}
NOT_BLOCKS = {"time_embed_0", "time_embed_1", "label_emb", "in_conv", "out_norm", "out_conv"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.trace_spans(False)
    spans.reset_spans()
    yield
    spans.trace_spans(False)
    spans.reset_spans()


@pytest.fixture(scope="module")
def ldm():
    return SliceLDM.create(timesteps=90, device="cpu", **UNET)  # DDIM-3's uniform nodes stay below T


@pytest.fixture(scope="module")
def ms():
    return MaskSampler.create(num_classes=4, time_steps=20, context_dim=24, text_refiner=REFINER, device="cpu",
                              **UNET)


def _blocks(unet) -> list:
    """The UNet's block spans, in calling order."""
    return [f"unet.{n}" for n, _ in unet.named_children() if n not in NOT_BLOCKS]


def _children(recs, i) -> list:
    """The records directly inside record i."""
    r = recs[i]
    return [c for c in recs[i + 1:] if c.depth == r.depth + 1 and r.host_open <= c.host_open
            and c.host_close <= r.host_close]


def _slice(ldm, sampler: str = "ddim"):
    mask = torch.linspace(0, 1, 2 * 16 * 16).reshape(1, 2, 16, 16, 1)
    ddim = DDIMParams.create(ldm.diffusion, 3)
    return next(ldm.stream_volume(NoiseSource(3, "cpu"), mask, ddim, sampler=sampler))


def _mask_volume(ms):
    context = torch.linspace(-1, 1, 2 * 5 * 24).reshape(2, 5, 24)
    mask_program, _ = make_chunked_two_stage_programs(ms, None, mask_shape=(2, 4, 8, 8), volume_shape=(8, 16, 16),
                                                      ddim=None, chunk=8, mask_steps=3,
                                                      cond=torch.zeros((2, 4, 8, 8, 1)), context=context)
    return mask_program(NoiseSource(4, "cpu"))


def test_off_records_nothing_and_allocates_no_span(ldm, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("an event was made with the recorder off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert spans.span("sampler.step", True) is spans.span("unet", False) is spans._OFF
    _slice(ldm)
    assert spans.records() == [] and spans.intervals() == []
    assert spans._REC.rows == [] and spans._REC.events == [] and spans._REC.free == []
    with spans.timed_span("request") as req:  # a timed span keeps its seconds, and nothing else
        pass
    assert req.seconds >= 0 and spans.records() == []


def test_off_span_allocates_no_memory():
    sys.getallocatedblocks()
    before = sys.getallocatedblocks()
    for _ in range(2000):
        with spans.span("unet.mid_attn", True):
            pass
    assert sys.getallocatedblocks() - before < 20


@pytest.mark.parametrize("sampler, calls", [("ddim", [1, 1, 1]), ("plms", [2, 1, 1]), ("dpm", [1, 1, 1])])
def test_slice_spans_under_the_profiler(ldm, sampler, calls):
    """A DDIM-3 slice of `stream_volume`: the concat, 3 `sampler.step` spans
    each holding its UNet calls (PLMS's first step two), each holding
    exactly the head, the UNet's blocks in order and the tail; then the
    min-max.  No card times on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]):
        _slice(ldm, sampler)
    recs = spans.records()
    top = [r.name for r in recs if r.depth == 0]
    assert top == ["slice.post", "sampler.step", "sampler.step", "sampler.step", "slice.post"]
    steps = [i for i, r in enumerate(recs) if r.name == "sampler.step"]
    assert [len(_children(recs, i)) for i in steps] == calls
    unets = [i for i, r in enumerate(recs) if r.name == "unet"]
    assert len(unets) == sum(calls) and all(recs[i].depth == 1 for i in unets)
    want = ["unet.head", *_blocks(ldm.unet), "unet.tail"]
    for i in unets:
        assert [c.name for c in _children(recs, i)] == want
    assert len(recs) == 2 + 3 + sum(calls) * (1 + len(want))
    assert all(r.card_open is None and r.card_close is None for r in recs)
    assert all(r.host_open <= r.host_close for r in recs)


@pytest.mark.parametrize("dims, mult", [(2, (1, 2, 4, 4, 5)), (3, (1, 2, 2, 4, 5))])
def test_46_block_spans_a_call_in_both_published_unets(dims, mult):
    """The stage-2 and stage-1 UNets' levels, blocks and attention sites at
    a tiny width: a call records 46 block spans, with the head and the tail
    48 inside its `unet` span."""
    from jointimagegeneration_torch.nn.unet import UNet

    unet = UNet(3, 8, 2, channel_mult=mult, attention_resolutions=(32, 16, 8), dims=dims, num_head_channels=4,
                device="cpu")
    x = torch.zeros((1, *[16] * dims, 3))
    with profile(activities=[ProfilerActivity.CPU]):
        unet(x, torch.ones(1))
    recs = spans.records()
    assert recs[0].name == "unet" and len(recs) == 1 + 48
    assert [r.name for r in recs[1:]] == ["unet.head", *_blocks(unet), "unet.tail"]
    assert len(_blocks(unet)) == 46


def test_mask_spans_under_the_profiler(ms):
    """A 3-step mask program: the refiner once, 3 `sampler.step` spans each
    holding one UNet call, then the hand-off (`upsample_labels`,
    `normalize_mask_channel`)."""
    with profile(activities=[ProfilerActivity.CPU]):
        _mask_volume(ms)
    recs = spans.records()
    assert [r.name for r in recs if r.depth == 0] == ["refiner", "sampler.step", "sampler.step", "sampler.step",
                                                      "handoff", "handoff"]
    for i, r in enumerate(recs):
        if r.name == "sampler.step":
            assert [c.name for c in _children(recs, i)] == ["unet"]
    want = ["unet.head", *_blocks(ms.unet), "unet.tail"]
    assert all([c.name for c in _children(recs, i)] == want for i, r in enumerate(recs) if r.name == "unet")


@pytest.mark.parametrize("route", ["ddim", "plms", "dpm", "mask"])
@pytest.mark.parametrize("how", ["profiler", "trace_spans"])
def test_outputs_equal_with_the_recorder_on_and_off(ldm, ms, route, how):
    run = (lambda: _mask_volume(ms)) if route == "mask" else (lambda: (_slice(ldm, route),))
    off = run()
    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            on = run()
    else:
        spans.trace_spans(True)
        on = run()
        spans.trace_spans(False)
    assert spans.records(), "the recorder recorded nothing"
    assert len(off) == len(on) and all(torch.equal(a, b) for a, b in zip(off, on))


def test_intervals_are_the_innermost_spans(ldm):
    """Over a real run, the pieces never overlap, each lies inside a span of
    its name, and no span of a lower depth covers a piece that a deeper
    span of the same instant holds."""
    with profile(activities=[ProfilerActivity.CPU]):
        _slice(ldm)
    recs = spans.records()
    pieces = spans.intervals(recs)
    assert all(s < e for s, e, _ in pieces)
    assert all(a[1] <= b[0] for a, b in zip(pieces, pieces[1:]))
    for s, e, name in pieces:
        holders = [r for r in recs if r.host_open <= s and e <= r.host_close]
        assert holders and max(holders, key=lambda r: r.depth).name == name
    for depth in {r.depth for r in recs}:
        at = sorted((r.host_open, r.host_close) for r in recs if r.depth == depth)
        assert all(a[1] <= b[0] for a, b in zip(at, at[1:]))


def _rec(name, depth, h0, h1, c0=None, c1=None):
    return spans.SpanRecord(name, depth, h0, h1, c0, c1)


def test_intervals_of_a_synthetic_record():
    recs = [_rec("step", 0, 0, 100), _rec("unet", 1, 10, 80), _rec("unet.a", 2, 20, 40), _rec("unet.b", 2, 40, 70),
            _rec("step", 0, 120, 150)]
    assert spans.intervals(recs) == [(0, 10, "step"), (10, 20, "unet"), (20, 40, "unet.a"), (40, 70, "unet.b"),
                                     (70, 80, "unet"), (80, 100, "step"), (120, 150, "step")]


def test_span_summary_and_table():
    recs = [_rec("step", 0, 0, 2_000_000, 500_000, 3_500_000), _rec("step", 0, 2_000_000, 6_000_000, 3_500_000,
                                                                    6_500_000),
            _rec("refiner", 0, 6_000_000, 7_000_000)]
    totals = spans.span_summary(recs)
    assert totals == {"step": [2, 6_000_000, 2, 6_000_000], "refiner": [1, 1_000_000, 0, 0]}
    assert spans.span_summary(recs[:1], totals)["step"] == [3, 8_000_000, 3, 9_000_000]
    table = spans.span_table(spans.span_summary(recs))
    assert table == {"step": {"count": 2, "issue_ms": 3.0, "card_ms": 3.0},
                     "refiner": {"count": 1, "issue_ms": 1.0, "card_ms": None}}


def test_sessions_and_trace_spans(ldm):
    """A session begins with the first span after the recorder turns on;
    what it recorded stays readable after the profiler stops, until the
    next one begins or `reset_spans`."""
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("a"):
            pass
    with spans.span("off"):  # off: recorded nowhere, and the session ends
        pass
    assert [r.name for r in spans.records()] == ["a"]
    spans.trace_spans(True)
    with spans.span("b"):
        with spans.timed_span("c") as c:
            pass
    assert [(r.name, r.depth) for r in spans.records()] == [("b", 0), ("c", 1)]
    assert c.seconds >= 0
    spans.reset_spans()
    assert spans.records() == []
    with spans.span("d"):
        spans.reset_spans()  # a span of an ended session leaves the new one alone
    assert spans.records() == []


TINY = {"stage": "two_stage", "seed": 3, "n_cases": 2, "batch_size": 1, "mask_steps": 3, "ddim_steps": 3,
        "volume_shape": [4, 16, 16], "chunk": 2, "device": "cpu", "fresh_init_noise": 0.02,
        "stage1": {"num_classes": 4, "time_steps": 20, "bf16": False,
                   "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                                   "num_head_channels": 4, "num_res_blocks": 1},
                   "dataset": {"volume_shape": [4, 8, 8]}},
        "stage2": {"slice_size": 16, "timesteps": 90, "bf16": False,
                   "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2],
                                              "attention_resolutions": [2], "num_head_channels": 4,
                                              "num_res_blocks": 1}}}}


def test_sample_cli_trace_spans(tmp_path, capsys):
    """`trace_spans: true`: the run's span table printed and written, each
    batch's records folded into it; the volumes equal the run's without;
    the recorder off and empty after it."""
    import json

    from jointimagegeneration_torch.cli import sample as cli

    off = cli.run({**TINY, "output_path": str(tmp_path / "off")})
    assert not (tmp_path / "off" / "spans.json").exists()
    on = cli.run({**TINY, "output_path": str(tmp_path / "on"), "trace_spans": True})
    assert "trace_spans: count, mean issue ms, mean card ms" in capsys.readouterr().out
    assert (on["ct"] == off["ct"]).all() and (on["labels"] == off["labels"]).all()
    table = json.loads((tmp_path / "on" / "spans.json").read_text())
    cases, slices = TINY["n_cases"], TINY["volume_shape"][0]
    assert table["sampler.step"]["count"] == cases * (TINY["mask_steps"] + slices * TINY["ddim_steps"])
    assert table["unet"]["count"] == table["sampler.step"]["count"]
    assert table["handoff"]["count"] == 2 * cases and table["slice.post"]["count"] == 2 * cases * slices
    assert all(row["card_ms"] is None and row["issue_ms"] > 0 for row in table.values())
    assert not spans._REC.forced and spans.records() == []


def test_trainer_profile_prints_the_span_table(capsys, tmp_path):
    """A trainer's `profile_steps` window prints the recorder's table beside
    the trace's kinds."""
    from jointimagegeneration_torch.train.trainer import Trainer

    printed = []
    trainer = Trainer.__new__(Trainer)
    trainer.cfg = type("Cfg", (), {"logdir": str(tmp_path), "profile_steps": 1})()
    trainer.device = torch.device("cpu")
    trainer._print_trace_summary = lambda trace: printed.append(trace)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    with spans.span("unet"):
        with spans.span("unet.head"):
            pass
    trainer._profile_stop(prof, 3)
    out = capsys.readouterr().out
    assert printed and "profiler: 1-step spans: count, mean issue ms, mean card ms" in out
    assert "unet.head" in out
