"""`norm_elementwise_ms.<suffix>`: `perfbench.readers.norm_elementwise_ms`, for every cell that lists it."""

from perfbench.readers import norm_elementwise_ms as read  # noqa: F401
