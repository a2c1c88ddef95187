"""`card_backlog_ms.<suffix>`: the median over the profiled segment's
`sampler.step` spans of the card's open less the host's, in ms: the work the
card still had queued when the host began a step.  Near 0 the host paces
every step; a deep backlog means the card sets the pace."""

import statistics

from perfbench.spans import card_steps


def read(run):
    steps = card_steps(run)
    return None if steps is None else statistics.median((r[4] - r[2]) / 1e6 for r in steps)
