"""`step_card_ms.<suffix>`: the mean card ms of the profiled segment's
`sampler.step` spans, from the card event at a step's open to the one at its
close: the card's time a step, where the step's work runs."""

import statistics

from perfbench.spans import card_steps


def read(run):
    steps = card_steps(run)
    return None if steps is None else statistics.fmean((r[5] - r[4]) / 1e6 for r in steps)
