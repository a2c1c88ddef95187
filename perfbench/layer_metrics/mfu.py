"""`mfu.<suffix>`: `perfbench.readers.mfu`, for every cell that lists it."""

from perfbench.readers import mfu as read  # noqa: F401
