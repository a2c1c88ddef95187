"""What the span readers read: the program's own span recorder
(`jointimagegeneration_torch.core.logging`), which is on while the profiled
segment of a `--trace 1` run records, so that its session is that segment.

A program without the recorder, or a segment in which it recorded no
`sampler.step`, gives None: the harness then leaves the metric out.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["sampler_steps", "card_steps"]


def sampler_steps(run) -> Optional[List[tuple]]:
    """The segment's `sampler.step` records, (name, depth, host_open,
    host_close, card_open, card_close) in ns, or None."""
    if run.profile is None:
        return None
    try:
        from jointimagegeneration_torch.core.logging import records
    except ImportError:
        return None
    steps = [r for r in records() if r[0] == "sampler.step"]
    return steps or None


def card_steps(run) -> Optional[List[tuple]]:
    """`sampler_steps` that carry card times, or None."""
    steps = [r for r in sampler_steps(run) or () if r[4] is not None]
    return steps or None
