"""`flash_roofline.<suffix>`: `perfbench.readers.flash_roofline`, for every cell that lists it."""

from perfbench.readers import flash_roofline as read  # noqa: F401
