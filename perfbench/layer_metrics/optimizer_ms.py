"""`optimizer_ms.<suffix>`: `perfbench.readers.optimizer_ms`, for every cell that lists it."""

from perfbench.readers import optimizer_ms as read  # noqa: F401
