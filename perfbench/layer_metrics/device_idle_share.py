"""`device_idle_share.<suffix>`: `perfbench.readers.device_idle_share`, for every cell that lists it."""

from perfbench.readers import device_idle_share as read  # noqa: F401
