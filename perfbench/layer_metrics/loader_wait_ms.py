"""`loader_wait_ms.<suffix>`: `perfbench.readers.loader_wait_ms`, for every cell that lists it."""

from perfbench.readers import loader_wait_ms as read  # noqa: F401
