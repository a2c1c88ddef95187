"""`step_issue_ms.<suffix>`: the mean host ms of the profiled segment's
`sampler.step` spans, from the step's open to its close on the host: the
issue of a whole step, the UNet call with the update, the draws and the
schedule's arithmetic."""

import statistics

from perfbench.spans import sampler_steps


def read(run):
    steps = sampler_steps(run)
    return None if steps is None else statistics.fmean((r[3] - r[2]) / 1e6 for r in steps)
