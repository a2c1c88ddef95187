"""GroupNorm with the timestep embedding's add, FiLM and SiLU fused: the
Hopper kernel pair, its launch planner, its plain version and the autograd
Function that joins them.

Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which fuses
it with its neighbours.  One call computes, on a channels-last (B, *spatial,
C) tensor x,

    y = act(((x + add[b, c]) - mu[b, g]) * rstd[b, g] * gamma[c] + beta[c])
        [* (1 + film_scale[b, c]) + film_shift[b, c]],

mu and rstd = 1 / sqrt(var + eps) the biased statistics of x + add over
each sample's group g of C / G channels, act SiLU or none.  x is bf16 or
fp32 and y comes back in x's dtype; add, gamma, beta and FiLM are fp32.

On CUDA tensors `group_norm_act` launches `csrc/group_norm.cu`'s two kernels
(the statistics, then the apply; counted in `group_norm_act.launches`) or
raises; the statistics, affine and activation are fp32 there and each output
element is rounded once.  How a call runs on the card (vector width, row
tiles, block shape, shared memory, workspace) is decided on the host by
`plan_group_norm`, a pure function of the shapes that the CPU tests check.
`group_norm_plain` is the plain version: the composite of PyTorch ops that
`nn.blocks.group_norm` runs on CPU tensors (the add and FiLM in x's dtype,
one cast after the affine, SiLU after it).  The backward recomputes through
it, as the conv kernel's Functions do (`ops/conv3d.py`); there is no
backward kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda.build import load_library
from .flash_attention import _cuda_bindings
from .launch_counters import counted

__all__ = ["GROUP_NORM_SOURCE", "GroupNormPlan", "plan_group_norm", "group_norm_plain", "group_norm_act",
           "live_buffers"]

GROUP_NORM_SOURCE = "group_norm"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

# The card the plans are made for (H100 SXM); csrc/group_norm.cu's blocks are
# at most MAX_THREADS and `__launch_bounds__(256, 4)` keeps BLOCKS_PER_SM of
# them resident on an SM.
SMS = 132
BLOCKS_PER_SM = 4
MAX_THREADS = 256
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (227 KB)
MIN_BLOCK_ELEMENTS = 4096  # elements a block streams at the least where a call fills a wave of four blocks an SM


@dataclass(frozen=True)
class GroupNormPlan:
    """How one GroupNorm call runs on the card (`plan_group_norm`).

    Both kernels run on the grid (tiles, b): block (t, b) owns rows [t *
    rows, (t + 1) * rows) of sample b, all C channels.  A row is nvec = C /
    vec vectors of `vec` elements (16 bytes where C allows it, else one
    element); `tpr` threads cover one row (vectors lane, lane + tpr, ...),
    `rpp` rows at a time, in blocks of `threads` (tpr * rpp rounded up to a
    warp).  The statistics kernel takes `smem_bytes` of dynamic shared
    memory; `workspace` floats hold the per-tile group partials (b, tiles,
    groups, 2) and then the per-(b, c) centre, scale and shift (3, b, c)."""

    vec: int
    tiles: int
    rows: int
    tpr: int
    rpp: int
    threads: int
    smem_bytes: int
    partial_floats: int
    workspace: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def plan_group_norm(b: int, s: int, c: int, groups: int, dtype: torch.dtype, aligned: bool = True) -> GroupNormPlan:
    """The launch plan of one call on b samples of s rows of c channels in
    `dtype`; `aligned` says x's data is 16-byte aligned.  A pure function of
    its arguments (cached).

    The vector is 16 bytes (8 bf16, 4 fp32) where C is a multiple of it and
    x is aligned, else one element.  A row's vectors go to at most
    MAX_THREADS threads in as few passes as cover them, equally filled; the
    rest of the block takes further rows.  The rows of a sample are cut into
    equal tiles: where the call holds MIN_BLOCK_ELEMENTS for each block of a
    full wave (SMS * BLOCKS_PER_SM blocks), into at most that many blocks,
    so that every SM streams with four blocks; below it, into at least a
    block for each SM (one row a tile at the least), so that a small call
    still reaches every SM but its last block folds few tiles."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"plan_group_norm: bf16 or fp32, got {dtype}")
    if min(b, s, c, groups) < 1 or c % groups:
        raise ValueError(f"plan_group_norm: b={b} s={s} c={c} groups={groups}")
    full = 16 // (2 if dtype == torch.bfloat16 else 4)
    vec = full if aligned and c % full == 0 else 1
    nvec = c // vec
    tpr = _cdiv(nvec, _cdiv(nvec, MAX_THREADS))
    rpp = max(1, MAX_THREADS // tpr)
    threads = _cdiv(tpr * rpp, 32) * 32
    smem = 4 * (2 * c + 2 * rpp * tpr * vec)
    if smem > SMEM_LIMIT:
        raise ValueError(f"plan_group_norm: C = {c} needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    wave = SMS * BLOCKS_PER_SM
    if b * s * c >= wave * MIN_BLOCK_ELEMENTS:
        rows = _cdiv(s, min(s, _cdiv(wave, b)))
    else:
        rows = max(1, s // _cdiv(SMS, b))
    tiles = _cdiv(s, rows)
    partial = b * tiles * groups * 2
    return GroupNormPlan(vec=vec, tiles=tiles, rows=rows, tpr=tpr, rpp=rpp, threads=threads, smem_bytes=smem,
                         partial_floats=partial, workspace=partial + 3 * b * c)


def _per_sample(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B, C) tensor in x's dtype, shaped to broadcast over x's spatial axes."""
    return t.to(x.dtype).reshape(t.shape[:1] + (1,) * (x.ndim - 2) + t.shape[1:])


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5,
                     silu: bool = False, add: Optional[torch.Tensor] = None,
                     film_scale: Optional[torch.Tensor] = None,
                     film_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: x + add (in x's dtype), the two-pass GroupNorm in
    fp32 cast back to x's dtype, then y * (1 + film_scale) + film_shift and
    SiLU, in x's dtype."""
    if add is not None:
        x = x + _per_sample(add, x)
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = (xn * gamma.float() + beta.float()).to(x.dtype)
    if film_scale is not None:
        y = y * (1 + _per_sample(film_scale, y)) + _per_sample(film_shift, y)
    return F.silu(y) if silu else y


class _Shape(ctypes.Structure):
    """csrc/group_norm.cu's `GnShape`: a call's shape and its plan's numbers."""

    _fields_ = [(name, ctypes.c_int) for name in ("b", "s", "c", "groups", "dtype", "vec", "tiles", "rows", "tpr",
                                                  "rpp", "threads", "smem_bytes", "add_stride", "scale_stride",
                                                  "shift_stride", "silu")] + [("eps", ctypes.c_float)]


_P = ctypes.c_void_p
_ARGTYPES = {"jig_gn_stats": [_P] * 8 + [ctypes.POINTER(_Shape), _P],
             "jig_gn_apply": [_P] * 3 + [ctypes.POINTER(_Shape), _P]}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A C entry point of csrc/group_norm.cu, built on first use."""
    fn = getattr(load_library(GROUP_NORM_SOURCE), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1024)
def _shape(b: int, s: int, c: int, groups: int, dtype: torch.dtype, aligned: bool, add_stride: int,
           scale_stride: int, shift_stride: int, silu: bool, eps: float):
    """(plan, a pointer to its `_Shape`) of a call, made once per shape: the
    C entry points take the numbers by pointer."""
    plan = plan_group_norm(b, s, c, groups, dtype, aligned)
    shape = _Shape(b, s, c, groups, _DTYPE_CODES[dtype], plan.vec, plan.tiles, plan.rows, plan.tpr, plan.rpp,
                   plan.threads, plan.smem_bytes, add_stride, scale_stride, shift_stride, int(silu), eps)
    return plan, ctypes.pointer(shape)


_buffers: Dict[int, Tuple[torch.Tensor, int]] = {}


def _buffer(device: torch.device, b: int, floats: int) -> Tuple[int, int]:
    """(address of b per-sample tile counters, address of `floats` fp32 of
    workspace) in the device's one buffer for every call: made zero, and
    left at zero where it counts by every statistics launch (so a call
    clears nothing), and reused call after call in stream order, so a call
    allocates nothing but its output.  It grows where a call needs more."""
    t, counters = _buffers.get(device.index, (None, 0))
    if t is None or counters < b or t.numel() - counters < floats:
        counters = max(counters, _cdiv(b, 64) * 64)
        t = torch.zeros(counters + max(floats, t.numel() - counters if t is not None else 0), dtype=torch.int32,
                        device=device)
        _buffers[device.index] = (t, counters)
    base = t.data_ptr()
    return base, base + 4 * counters


def live_buffers() -> Tuple[torch.Tensor, ...]:
    """The buffers that calls use now, one a device.  A CUDA graph that
    captured calls keeps them (`nn/graphed.py`): a later call that grows a
    buffer drops it here, and the graph's replays still read it."""
    return tuple(t for t, _ in _buffers.values())


def _launch_pair(fn, ptrs: Dict[str, Optional[int]], shape, stream: int) -> None:
    """Issues a call's two kernels in order through `fn` (name -> C entry
    point; `_kernel_fn` on the card): the statistics, then the apply.  `ptrs`
    holds the device addresses of x, add, gamma, beta, film_scale,
    film_shift, the workspace (the partials, then the coefficients), the
    counters and y; `shape` points to the call's `_Shape`.  Raises on the
    first launch that fails; counts each launch."""
    err = fn("jig_gn_stats")(ptrs["x"], ptrs["add"], ptrs["gamma"], ptrs["beta"], ptrs["film_scale"],
                             ptrs["film_shift"], ptrs["work"], ptrs["counter"], shape, stream)
    if err != 0:
        raise RuntimeError(f"group_norm statistics launch failed: cudaError {err} at {_shape_text(shape)}")
    group_norm_act.launches += 1
    err = fn("jig_gn_apply")(ptrs["x"], ptrs["work"], ptrs["y"], shape, stream)
    if err != 0:
        raise RuntimeError(f"group_norm apply launch failed: cudaError {err} at {_shape_text(shape)}")
    group_norm_act.launches += 1


def _shape_text(shape) -> str:
    return str({name: getattr(shape.contents, name) for name, _ in _Shape._fields_})


def _row_stride(t: torch.Tensor, b: int, c: int, who: str) -> int:
    """The row stride of a (b or 1, c) fp32 tensor with contiguous rows (0:
    one row for every sample)."""
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != c or t.stride(1) != 1 or t.shape[0] not in (1, b):
        raise ValueError(f"group_norm_act: {who} must be ({b}, {c}) fp32 with contiguous rows, got "
                         f"{tuple(t.shape)} {t.dtype} strides {t.stride()}")
    return t.stride(0) if t.shape[0] == b else 0


def _forward_kernel(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float, silu: bool,
                    add: Optional[torch.Tensor], film_scale: Optional[torch.Tensor],
                    film_shift: Optional[torch.Tensor]) -> torch.Tensor:
    x = x.contiguous()
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    b, c = x.shape[0], x.shape[-1]
    add_stride = scale_stride = shift_stride = 0
    if add is not None:
        add_stride = _row_stride(add, b, c, "add")
    if film_scale is not None:
        scale_stride, shift_stride = _row_stride(film_scale, b, c, "film_scale"), _row_stride(film_shift, b, c,
                                                                                              "film_shift")
    x_ptr = x.data_ptr()
    plan, shape = _shape(b, n // (b * c), c, groups, x.dtype, x_ptr % 16 == 0, add_stride, scale_stride, shift_stride,
                         silu, eps)
    device = x.device
    counter, work = _buffer(device, b, plan.workspace)
    ptrs = {"x": x_ptr, "add": add.data_ptr() if add is not None else None, "gamma": gamma.data_ptr(),
            "beta": beta.data_ptr(), "film_scale": film_scale.data_ptr() if film_scale is not None else None,
            "film_shift": film_shift.data_ptr() if film_shift is not None else None, "work": work,
            "counter": counter, "y": y.data_ptr()}
    index, (current_device, raw_stream) = device.index, _cuda_bindings()
    if index == current_device():
        _launch_pair(_kernel_fn, ptrs, shape, raw_stream(index))
    else:
        with torch.cuda.device(index):
            _launch_pair(_kernel_fn, ptrs, shape, raw_stream(index))
    return y


class _GroupNormAct(torch.autograd.Function):
    """The kernel pair's forward; the backward recomputes through
    `group_norm_plain` (the JAX package differentiates XLA's GroupNorm)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, add, film_scale, film_shift, groups, eps, silu):
        ctx.save_for_backward(x, gamma, beta, add, film_scale, film_shift)
        ctx.opts = (groups, eps, silu)
        return _forward_kernel(x, gamma, beta, groups, eps, silu, add, film_scale, film_shift)

    @staticmethod
    def backward(ctx, dy):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:6])]
        x, gamma, beta, add, film_scale, film_shift = inputs
        groups, eps, silu = ctx.opts
        with torch.enable_grad():
            y = group_norm_plain(x, gamma, beta, groups, eps, silu, add, film_scale, film_shift)
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        got = iter(torch.autograd.grad(y, wrt, dy, allow_unused=True) if wrt else ())
        return (*(next(got) if t is not None and t.requires_grad else None for t in inputs), None, None, None)


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float = 1e-5,
                   silu: bool = False, add: Optional[torch.Tensor] = None, film_scale: Optional[torch.Tensor] = None,
                   film_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(GroupNorm(x + add) [* (1 + film_scale) + film_shift]) of a
    channels-last (B, *spatial, C) CUDA tensor, bf16 or fp32, by the kernel
    pair (counted in `group_norm_act.launches`), differentiable.  gamma and
    beta are (C,) fp32; add, film_scale and film_shift (B, C) fp32 with
    contiguous rows (or one row for every sample), or None."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES or x.ndim < 2:
        raise TypeError(f"group_norm_act takes a bf16 or fp32 (B, ..., C) tensor, got {x.dtype} {tuple(x.shape)}")
    c = x.shape[-1]
    if c % groups or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"group_norm_act: C = {c}, {groups} groups, gamma {tuple(gamma.shape)}, beta "
                         f"{tuple(beta.shape)}")
    if (film_scale is None) != (film_shift is None):
        raise ValueError("group_norm_act: film_scale and film_shift come together")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        gamma, beta = gamma.float(), beta.float()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, gamma, beta, add, film_scale, film_shift)):
        return _GroupNormAct.apply(x, gamma, beta, add, film_scale, film_shift, groups, eps, silu)
    return _forward_kernel(x, gamma, beta, groups, eps, silu, add, film_scale, film_shift)


counted(group_norm_act, launches=0)
