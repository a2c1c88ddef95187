"""The kernel wrappers that count their launches in Python.

A wrapper keeps each of its counts as an integer attribute whose name ends
in `launches` (`flash_forward.launches`, `conv3d_igemm.splitk_launches`,
...) and sets them up where it is defined with `counted(fn, launches=0)`,
which enters the wrapper in `COUNTED`.  A CUDA graph's capture runs the
wrappers' Python but launches nothing, and its replays run no Python:
`nn/graphed.py` reads `counts()` to move what a capture counted onto each
replay, so every counter here counts what the card runs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

__all__ = ["COUNTED", "counted", "counts"]

COUNTED: List[Callable] = []


def counted(fn: Callable, **counters: int) -> Callable:
    """Sets `fn`'s counters (names ending in `launches`) and enters `fn` in
    `COUNTED`; returns `fn`."""
    for name, value in counters.items():
        if not name.endswith("launches"):
            raise ValueError(f"counted: a launch counter's name ends in 'launches', got {name!r}")
        setattr(fn, name, value)
    if fn not in COUNTED:
        COUNTED.append(fn)
    return fn


def counts() -> Dict[Tuple[Callable, str], int]:
    """Every counter of every wrapper in `COUNTED`: (wrapper, name) -> count."""
    return {(fn, name): value for fn in COUNTED for name, value in vars(fn).items()
            if name.endswith("launches") and isinstance(value, int)}
