"""`unet_host_ms.<suffix>`: `perfbench.readers.unet_host_ms`, for every cell that lists it."""

from perfbench.readers import unet_host_ms as read  # noqa: F401
