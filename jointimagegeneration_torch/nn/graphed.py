"""Inference calls of a module replayed as CUDA graphs.

A UNet call issues ~1,000 kernels from Python, and on the card the host's
issue, not the kernels, sets the pace of every sampler loop.  `GraphCache`
captures a call once into a `torch.cuda.CUDAGraph` and replays that graph on
later calls with the same signature: one launch in place of the call's
Python dispatch.

What a call shows decides, and nothing else (no config key, no environment
variable).  `GraphCache.eligible` admits a call when autograd is off, every
input is a tensor on the module's CUDA device (or None), no autocast is on,
the current stream is not itself capturing, and no forward hook is set on a
submodule or globally (a replay runs no Python, so such a hook would not
fire); the caller adds its own conditions (the UNet: no mesh over other
devices, no `spatial_axis`).  Every other call runs eager, as before.
`eager_unet()` forces eager inside it; tests and `chip_smoke.py` use it to
compare the two, nothing in `configs/` or the CLIs.

The key of a call: the shape, dtype and strides of each tensor input (None
kept apart from a tensor), the caller's extra key (the UNet: its
`feature_cond` sites), the data pointers of the module's parameters and
buffers, the TF32, cuDNN and inference-mode flags in force and the current
stream.  An in-place change of a weight (a load, an optimizer step) keeps
the pointers and is read by the next replay; `.to()` or a replaced
`Parameter` changes them, and the call is captured anew.

A key's first call runs eager: it is the warm-up (cuDNN's algorithm choice,
lazy library loads, the GroupNorm buffer's growth).  Its second call copies
the inputs into buffers of its own, captures the call on its pool's side
stream (`unet.capture` span; spans are paused inside it) and, since a capture runs
no kernel, replays the graph once for its output.  Later calls copy their
inputs into those buffers, replay, and return a clone of the graph's output,
so an output survives the next replay (classifier-free guidance calls one
key twice a step).  Each cache keeps `SIZE` graphs and drops the least
recently used one beyond that; the last `SEEN` first calls are remembered for
their second.  A cache's graphs on one stream share one memory pool: a replay
writes each pool buffer it reads before it reads it, and its output is
cloned before the next replay is issued on that stream, so one graph may
overwrite another's buffers.  The pool then holds the largest call's
activations and each graph's output, not the sum of their activations.

The kernel wrappers count their launches in Python (`flash_forward.launches`,
`group_norm_act.launches`, `plain_attention.launches`: every wrapper in
`ops.launch_counters.COUNTED`), which a replay does not run.  A capture
takes back what it added to each counter and keeps it as the graph's delta,
which every replay adds: the counters count what the card runs, as on the
eager path.  `unet_graph.captures` and `unet_graph.replays` count captures
and replays (a capture's own first replay is not counted among the
replays).

A device buffer that persists across calls and that a captured call reads
must outlive the graph: each graph keeps the GroupNorm kernels' workspace
(`ops.group_norm.live_buffers`) that it captured, so a later call that grows
it frees nothing a replay reads.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core.logging import span, spans_paused
from ..ops import group_norm
from ..ops.launch_counters import counts

__all__ = ["GraphCache", "CudaGraph", "eager_unet", "unet_graph"]

unet_graph = SimpleNamespace(captures=0, replays=0)

_forced_eager = threading.local()
SIZE = 4  # the graphs a cache keeps: a sampler or a server makes one key a batch size (PERF.md §6)
SEEN = 64  # the keys of first calls a cache remembers for their second


@contextlib.contextmanager
def eager_unet():
    """Every call inside runs eager on this thread (for tests and
    measurement scripts that compare the two paths)."""
    before = getattr(_forced_eager, "depth", 0)
    _forced_eager.depth = before + 1
    try:
        yield
    finally:
        _forced_eager.depth = before


def _autocast() -> bool:
    try:
        return torch.is_autocast_enabled("cuda")
    except TypeError:  # a PyTorch without the device argument
        return torch.is_autocast_enabled()


def _flags() -> tuple:
    """The global settings that change which kernels a call runs."""
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.enabled, b.cudnn.benchmark, b.cudnn.deterministic,
            b.cuda.matmul.allow_bf16_reduced_precision_reduction,
            b.cuda.matmul.allow_fp16_reduced_precision_reduction, torch.get_float32_matmul_precision(),
            torch.are_deterministic_algorithms_enabled(), torch.is_inference_mode_enabled())


class CudaGraph:
    """One call captured on the card and replayed on the current stream."""

    device_type = "cuda"

    def __init__(self, device: torch.device, pool):
        self.device, self.pool = device, pool
        self.graph = torch.cuda.CUDAGraph()

    @staticmethod
    def new_pool(device: torch.device) -> tuple:
        """A memory pool and the side stream that captures into it (the
        caching allocator reuses a freed block only on its own stream)."""
        return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)

    def capture(self, fn: Callable, inputs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """fn(*inputs) captured on the pool's side stream (no kernel runs);
        its output, in the pool."""
        handle, side = self.pool
        stream = torch.cuda.current_stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=handle, capture_error_mode="thread_local")
            try:
                out = fn(*inputs)
            finally:
                self.graph.capture_end()
        stream.wait_stream(side)
        return out

    def replay(self) -> None:
        self.graph.replay()

    @staticmethod
    def stream(device: torch.device) -> int:
        return torch.cuda.current_stream(device).cuda_stream

    @staticmethod
    def capturing() -> bool:
        return torch.cuda.is_current_stream_capturing()


class _Entry:
    __slots__ = ("graph", "inputs", "output", "delta", "keep")

    def __init__(self, graph, inputs, output, delta, keep):
        self.graph, self.inputs, self.output, self.delta, self.keep = graph, inputs, output, delta, keep


def _signature(t: Optional[torch.Tensor]):
    return None if t is None else (t.shape, t.dtype, t.stride())


class GraphCache:
    """A module's captured calls, by key (see the module's docstring).
    `graph` makes the object that captures and replays one call: `CudaGraph`
    on the card; the CPU tests pass a stand-in."""

    def __init__(self, graph=CudaGraph):
        self.graph_type = graph
        self.graphs: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.seen: "OrderedDict[tuple, None]" = OrderedDict()
        self.pools: Dict[tuple, tuple] = {}  # (device, stream) -> the pool its graphs share
        self.lock = threading.Lock()

    def __reduce__(self):  # a copy of the module (a mesh replica) starts with no graphs
        return GraphCache, (self.graph_type,)

    def __len__(self) -> int:
        return len(self.graphs)

    def eligible(self, module: torch.nn.Module, inputs: Sequence[Optional[torch.Tensor]]) -> bool:
        """Whether the call may replay a graph: see the module's docstring
        (the submodules' hooks are checked by `key`)."""
        if getattr(_forced_eager, "depth", 0) or torch.is_grad_enabled():
            return False
        device = next(module.parameters()).device
        if device.type != self.graph_type.device_type:
            return False
        if any(t is not None and (not isinstance(t, torch.Tensor) or t.device != device) for t in inputs):
            return False
        hooks = torch.nn.modules.module
        if hooks._global_forward_hooks or hooks._global_forward_pre_hooks:
            return False
        return not (_autocast() or self.graph_type.capturing())

    def key(self, module: torch.nn.Module, inputs: Sequence[Optional[torch.Tensor]], extra=()) -> Optional[tuple]:
        """The call's key, or None where a submodule has forward hooks."""
        pointers: List[int] = []
        for m in module.modules():
            if m is not module and (m._forward_hooks or m._forward_pre_hooks):
                return None
            pointers += [t.data_ptr() for t in m._parameters.values() if t is not None]
            pointers += [t.data_ptr() for t in m._buffers.values() if t is not None]
        device = inputs[0].device
        return (tuple(_signature(t) for t in inputs), extra, tuple(pointers), _flags(), device,
                self.graph_type.stream(device))

    def run(self, module: torch.nn.Module, fn: Callable, inputs: Sequence[Optional[torch.Tensor]],
            extra=()) -> torch.Tensor:
        """fn(*inputs) for an eligible call: eager, captured or replayed."""
        key = self.key(module, inputs, extra)
        if key is None:
            return fn(*inputs)
        with self.lock:
            entry = self.graphs.get(key)
            if entry is not None:
                self.graphs.move_to_end(key)
                unet_graph.replays += 1
                return self._replay(entry, inputs)
            if key not in self.seen:
                self.seen[key] = None
                while len(self.seen) > SEEN:
                    self.seen.popitem(last=False)
                return fn(*inputs)
            del self.seen[key]
            entry = self._capture(fn, inputs, key[-2:])
            self.graphs[key] = entry
            while len(self.graphs) > SIZE:
                self.graphs.popitem(last=False)
            unet_graph.captures += 1
            return self._replay(entry, inputs)

    def _capture(self, fn: Callable, inputs: Sequence[Optional[torch.Tensor]], place: tuple) -> _Entry:
        static = [None if t is None else torch.empty_like(t).copy_(t) for t in inputs]
        if place not in self.pools:
            self.pools[place] = self.graph_type.new_pool(place[0])
        graph = self.graph_type(inputs[0].device, self.pools[place])
        before = counts()
        with span("unet.capture"), spans_paused():
            output = graph.capture(fn, static)
        delta = {}
        for (fn_, name), value in counts().items():
            added = value - before.get((fn_, name), 0)
            if added:
                setattr(fn_, name, value - added)
                delta[(fn_, name)] = added
        return _Entry(graph, static, output, tuple(delta.items()), group_norm.live_buffers())

    @staticmethod
    def _replay(entry: _Entry, inputs: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        for buf, t in zip(entry.inputs, inputs):
            if buf is not None:
                buf.copy_(t)
        entry.graph.replay()
        for (fn, name), added in entry.delta:
            setattr(fn, name, getattr(fn, name) + added)
        return entry.output.clone()
