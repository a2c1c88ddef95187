"""Flash attention: the Hopper kernels, their wrappers, their plain versions
and the autograd Function that joins them.

Counterpart of `jointimagegeneration_tpu/ops/pallas/flash_attention.py`.
  * Forward (`csrc/flash_fwd.cu`, wrapper `flash_forward`) replaces that
    file's forward kernels (`_flash_kernel_unrolled`, `_flash_kernel`,
    `_flash_kernel_pipelined`, entered through `_flash_forward`): O =
    softmax(q.k^T).v with an online softmax in fp32, plus the fp32 logsumexp.
    How it runs on the card (head width, warpgroups per block, shared
    memory; in fp32 the splits of the key loop, whose partial states
    `flash_fwd_merge` combines) is decided on the host by `plan_flash_fwd`.
  * Backward (`csrc/flash_bwd.cu`, wrappers `flash_bwd_dq` and `flash_bwd_dkv`,
    joined by `flash_backward`) replaces `_bwd_dkv_kernel` and
    `_bwd_dq_kernel` (entered through `_flash_backward`): dK, dV and dQ
    recomputed from the saved LSE.  The dq kernel runs first and also
    computes delta = rowsum(dO * O), which the dkv kernel reads.  How each
    runs on the card (warpgroups per block, shared memory; in fp32 the
    splits of its streamed loop, whose partials `flash_bwd_reduce` sums) is
    decided on the host by `plan_flash_bwd`, a pure function of the shapes.
  * `FlashAttention` is the `torch.autograd.Function` that takes the place of
    the custom_vjp `_flash`.
The sources' comments give each kernel's bound and design.

Layout is the JAX package's: (BH, T, D), q already scaled by 1/sqrt(D), and
`flash_attention` takes (B, H, T, D) and does the scaling outside the
Function, so autograd carries the scale into dq.  On CPU tensors every
wrapper computes its plain version (which also takes float64, for
`torch.autograd.gradcheck`); on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .cuda.build import load_library
from .launch_counters import counted

__all__ = ["flash_forward", "flash_attention_plain", "flash_backward", "flash_backward_plain",
           "flash_bwd_dkv", "flash_bwd_dq", "FlashAttention", "flash_attention", "flash_eligible",
           "FLASH_SOURCE", "FLASH_BWD_SOURCE", "FlashFwdPlan", "plan_flash_fwd", "BwdKernelPlan",
           "FlashBwdPlan", "plan_flash_bwd", "flash_bwd_reduce", "flash_bwd_reduce_plain", "f32_bwd_rows",
           "f32_bwd_splits", "f32_fwd_rows", "flash_fwd_merge", "flash_fwd_merge_plain"]

FLASH_SOURCE = "flash_fwd"
FLASH_BWD_SOURCE = "flash_bwd"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_MAX_D = 256


def flash_eligible(tq: int, tk: int, d: int, block_q: int = 1024, block_k: int = 1024) -> bool:
    """The JAX package's shape rule (flash_attention.py:406-413): blocks halve
    from 1024 while they do not divide T and are >= 128; the kernel is taken
    only if the final blocks divide Tq and Tk and D <= 256."""
    bq = min(block_q, tq)
    while bq >= 128 and tq % bq:
        bq //= 2
    bk = min(block_k, tk)
    while bk >= 128 and tk % bk:
        bk //= 2
    return not (tq % bq or tk % bk or d > _MAX_D)


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions compute in fp32, or in float64 for float64 inputs."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (BH, Tq, D) x (BH, Tk, D)
    -> (O (BH, Tq, D) in q's dtype, LSE (BH, Tq, 1) fp32); q pre-scaled.
    Scores and softmax in fp32, P rounded to v's dtype for P.V, as the kernel
    does."""
    acc = _acc(q)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc)) / l
    return o.to(q.dtype), m + torch.log(l)


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                         lse: torch.Tensor, do: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels, step for step as
    `_flash_backward` (flash_attention.py:309-352): (dq, dk, dv) in the input
    dtypes.  P is rounded to dO's dtype before P^T.dO and dS to q's (k's)
    dtype before dS^T.q (dS.k); everything else is fp32."""
    acc = _acc(q)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    delta = (dof * o.to(acc)).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) - lse.to(acc))
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2), qf)
    dq = torch.matmul(ds.to(k.dtype).to(acc), kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The card the plans are made for (H100 SXM) and the kernels' fixed shapes;
# csrc/flash_{fwd,bwd}.cu and csrc/flash_common.cuh hold the same numbers, and
# the kernels check the plans' shared memory.
SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (227 KB)
TILE = 64             # q rows (forward, dq) or keys (dkv) per block, rows per streamed tile
STAGES = 2            # stages in each warpgroup's ring of streamed tiles
F32_THREADS = 256     # threads of an fp32 block (forward and backward)
F32_MAX_SPLITS = 16   # bounds the workspace (splits x the output) and the merge's or reduce's reads
_HEAD_WIDTHS = (16, 32, 64, 128, 256)


def _head_width(d: int) -> int:
    return next(w for w in _HEAD_WIDTHS if d <= w)


@dataclass(frozen=True)
class FlashFwdPlan:
    """How one forward call runs on the card: the head width `head_width` D
    is padded to (16, 32, 64, 128 or 256), the output head columns `chunk` of
    one block (and, in bf16, of one swizzle atom), the bytes `swizzle` of a
    swizzled tile row (bf16: 32, 64 or 128; fp32: 0), `warpgroups` of 128
    threads per block (0 for the fp32 kernel, blocks of F32_THREADS threads),
    `threads` and `smem_bytes` per block, `grid` blocks: one per (bh, 64-row q
    tile, head-column chunk, split), `rows` keys per streamed tile, and
    `splits` blocks sharing each block's key loop (1 in bf16; fp32 partial
    states combined by one merge launch where it is > 1)."""

    head_width: int
    chunk: int
    swizzle: int
    warpgroups: int
    threads: int
    smem_bytes: int
    grid: int
    rows: int = TILE
    splits: int = 1

    @property
    def merge_launches(self) -> int:
        """Launches of the split merge this call adds: 1 where the key loop
        is split, else 0."""
        return int(self.splits > 1)


def _fwd_smem(hd: int, warpgroups: int) -> int:
    """csrc/flash_fwd.cu's `FwdSmem`: 1024 bytes of alignment slack, the
    1024-byte barrier slot, the Q tile (64 x hd bf16), then per warpgroup a
    ring of STAGES stages of (K tile, the V tile's 64 x min(hd, 64) chunk)."""
    tile, atom = TILE * hd * 2, TILE * min(hd, 64) * 2
    return 2048 + tile + warpgroups * STAGES * (tile + atom)


@functools.lru_cache(maxsize=256)
def plan_flash_fwd(bh: int, tq: int, tk: int, d: int, dtype: torch.dtype) -> FlashFwdPlan:
    """The launch plan of one forward call of (bh, tq, d) queries against
    (bh, tk, d) keys.  A pure function of its arguments (cached).

    bf16: D is padded to the next of 16, 32, 64, 128, 256; tiles are
    swizzled in rows of min(D, 64) columns; one block per 64-row q tile and
    64-column output chunk.  Two warpgroups, splitting the block's key tiles,
    where one-warpgroup blocks would number at most two per SM (SMS * 2) and
    D < 256: as for the backward's dq, that doubles the warpgroups in flight
    whose exponentials and products interleave; at more blocks a second
    warpgroup per block only adds the merge.

    fp32: blocks of F32_THREADS threads own 64 q rows and one output chunk of
    min(D, 64) head columns (each recomputing S over all of D) and stream K
    and V tiles of `f32_fwd_rows(hd)` keys; `f32_bwd_splits` splits each
    block's key loop over blocks, so that the grid fills the card where the
    work allows, and the merge kernel combines the splits' partial (m, l, O)
    in split order.  (`scripts/bench_flash_fwd.py --fp32` on an H100: the
    rule's count was the fastest of 1, 2, 3, 4 and 8 splits at (8, 512, 64)
    and (8, 2048, 32), and 4% behind 4 splits at (8, 640, 64).)"""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"plan_flash_fwd: bf16 or fp32, got {dtype}")
    if min(bh, tq, tk, d) < 1 or d > _MAX_D:
        raise ValueError(f"plan_flash_fwd: unsupported shape bh={bh} tq={tq} tk={tk} d={d}")
    hd = _head_width(d)
    chunk = min(hd, 64)
    blocks = _cdiv(tq, TILE) * bh * (hd // chunk)
    if dtype == torch.float32:
        rt = f32_fwd_rows(hd)
        splits = f32_bwd_splits(blocks, _cdiv(tk, rt))
        return FlashFwdPlan(hd, chunk, 0, 0, F32_THREADS, _f32_fwd_smem(hd), blocks * splits, rt, splits)
    wg = 2 if hd < 256 and blocks <= 2 * SMS else 1
    return FlashFwdPlan(hd, chunk, 2 * chunk, wg, 128 * wg, _fwd_smem(hd, wg), blocks)


@dataclass(frozen=True)
class BwdKernelPlan:
    """One backward kernel's launch (`plan_flash_bwd`): `warpgroups` of 128
    threads per block (0 for the fp32 kernels, blocks of 256 threads),
    `threads` and `smem_bytes` per block, `rows` of a streamed tile (q rows in
    dkv, keys in dq), `splits` blocks sharing each block's streamed loop (1
    in bf16; fp32 partials summed by one reduce launch where it is > 1), and
    `grid` blocks: one per (bh, 64-row tile, head-column chunk, split)."""

    warpgroups: int
    threads: int
    smem_bytes: int
    grid: int
    rows: int = TILE
    splits: int = 1

    @property
    def reduce_launches(self) -> int:
        """Launches of the split reduce this kernel's call adds: 1 where the
        loop is split, else 0."""
        return int(self.splits > 1)


@dataclass(frozen=True)
class FlashBwdPlan:
    """How one backward call runs on the card: the head width `head_width`
    D is padded to (16, 32, 64, 128 or 256), the output head columns
    `chunk` of one block (and of one swizzle atom), the bytes `swizzle` of a
    swizzled tile row (bf16: 32, 64 or 128; fp32: 0), and the two kernels'
    launches, dq first."""

    head_width: int
    chunk: int
    swizzle: int
    dkv: BwdKernelPlan
    dq: BwdKernelPlan


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bwd_smem(kernel: str, hd: int, warpgroups: int) -> int:
    """csrc/flash_bwd.cu's `Smem`: 1024 bytes of alignment slack, a 1024-byte
    control slot (the mbarriers, and dq's delta), the block's own two tiles
    (dkv: K, V; dq: Q, dO), then per warpgroup a ring of STAGES stages of (Q
    tile, dO tile, a 1024-byte LSE and delta slot) in dkv, of (K tile, V
    tile) in dq.  A tile is 64 x hd bf16."""
    tile = TILE * hd * 2
    return 2048 + 2 * tile + warpgroups * STAGES * (2 * tile + (1024 if kernel == "dkv" else 0))


def f32_fwd_rows(hd: int) -> int:
    """Keys of an fp32 forward kernel's streamed K / V tile (csrc/flash_fwd.cu's
    `f32_fwd_rows`): 64 up to D = 64, 32 up to 128, 16 at 256."""
    return 64 if hd <= 64 else (32 if hd <= 128 else 16)


def _f32_fwd_smem(hd: int) -> int:
    """csrc/flash_fwd.cu's `F32FwdSmem`, in bytes: the block's Q tile of 64
    rows, two stages of (K tile, V tile) of `f32_fwd_rows` rows (rows of hd + 4
    floats), and P as (rows, 64 + 4)."""
    rt, ld = f32_fwd_rows(hd), hd + 4
    return 4 * (TILE * ld + 2 * 2 * rt * ld + rt * (TILE + 4))


def f32_bwd_rows(hd: int) -> int:
    """Rows of an fp32 backward kernel's streamed tile (csrc/flash_bwd.cu's
    `f32_rows`): 64 up to D = 32, 32 up to 128, 16 at 256."""
    return 64 if hd <= 32 else (32 if hd <= 128 else 16)


def _f32_bwd_smem(kernel: str, hd: int) -> int:
    """csrc/flash_bwd.cu's `F32Smem`, in bytes: the block's own two tiles of
    64 rows, two stages of the streamed pair of `f32_bwd_rows` rows (rows of
    hd + 4 floats), the row data (dkv: per stage LSE and delta of the tile's
    rows; dq: the block's 64 rows'), and the transposed tiles of 64 + 4
    floats a row (dkv: P and dS; dq: dS)."""
    rt, ld = f32_bwd_rows(hd), hd + 4
    dkv = kernel == "dkv"
    rows, trans = (4 * rt, 2 * rt * (TILE + 4)) if dkv else (2 * TILE, rt * (TILE + 4))
    return 4 * (2 * TILE * ld + 2 * 2 * rt * ld + rows + trans)


def f32_bwd_splits(blocks: int, streamed_tiles: int) -> int:
    """Splits of an fp32 kernel's streamed loop: as many as keep the grid
    within two blocks per SM (2 * SMS), at most one per streamed tile and at
    most F32_MAX_SPLITS."""
    return max(1, min(streamed_tiles, F32_MAX_SPLITS, (2 * SMS) // blocks))


@functools.lru_cache(maxsize=256)
def plan_flash_bwd(bh: int, tq: int, tk: int, d: int, dtype: torch.dtype) -> FlashBwdPlan:
    """The launch plan of one backward call of (bh, tq, d) queries against
    (bh, tk, d) keys.  A pure function of its arguments (cached).

    D is padded to the next of 16, 32, 64, 128, 256, and each block owns 64
    keys (dkv) or 64 q rows (dq) and one output chunk of min(D, 64) head
    columns, recomputing S and dP over all of D.

    bf16: tiles are swizzled in rows of min(D, 64) columns, with a ring of
    STAGES stages per warpgroup.  dkv takes one warpgroup per block (three
    blocks share an SM up to D = 32, two above).  dq takes two, splitting
    the block's key tiles, where one-warpgroup blocks would number at most
    two per SM (SMS * 2): that doubles the warpgroups in flight, which the
    latency of each warpgroup's serial chain (products, exponentials,
    products) needs; at more blocks two warpgroups per block only add a
    reduction.  (Measured on an H100 at the training shapes,
    `scripts/bench_flash_bwd.py`: two warpgroups ran dq 8-10% faster at
    (8, 2048, 32) and (16, 1024, 32) and 5% slower at (20, 1024, 32); dkv
    17-37% slower at every shape, so its kernel has one warpgroup.)

    fp32: blocks of F32_THREADS threads stream tiles of `f32_bwd_rows(hd)`
    rows, and `f32_bwd_splits` splits each block's streamed loop (dkv: the q
    tiles, dq: the key tiles) over blocks, so that the grid fills the card
    where the work allows; the split partials are then summed by the reduce
    kernel in split order."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"plan_flash_bwd: bf16 or fp32, got {dtype}")
    if min(bh, tq, tk, d) < 1 or d > _MAX_D:
        raise ValueError(f"plan_flash_bwd: unsupported shape bh={bh} tq={tq} tk={tk} d={d}")
    hd = _head_width(d)
    chunk = min(hd, 64)
    nch = hd // chunk
    plans = {}
    for kernel, rows, streamed in (("dkv", tk, tq), ("dq", tq, tk)):
        blocks = _cdiv(rows, TILE) * bh * nch
        if dtype == torch.float32:
            rt = f32_bwd_rows(hd)
            splits = f32_bwd_splits(blocks, _cdiv(streamed, rt))
            plans[kernel] = BwdKernelPlan(0, F32_THREADS, _f32_bwd_smem(kernel, hd), blocks * splits, rt, splits)
        else:
            wg = 2 if kernel == "dq" and hd < 256 and blocks <= 2 * SMS else 1
            plans[kernel] = BwdKernelPlan(wg, 128 * wg, _bwd_smem(kernel, hd, wg), blocks)
    swizzle = 2 * chunk if dtype == torch.bfloat16 else 0
    return FlashBwdPlan(hd, chunk, swizzle, dkv=plans["dkv"], dq=plans["dq"])


# C entry point -> (source under csrc/, ctypes argument types); the
# kernels' entries take pointers, then ints, then the stream
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY_POINTS = {"jig_flash_fwd": (FLASH_SOURCE, [_P] * 7 + [_I] * 8 + [_P]),
                 "jig_flash_fwd_merge": (FLASH_SOURCE, [_P] * 4 + [ctypes.c_longlong, _I, _I, _P]),
                 "jig_flash_bwd_dkv": (FLASH_BWD_SOURCE, [_P] * 9 + [_I] * 8 + [_P]),
                 "jig_flash_bwd_dq": (FLASH_BWD_SOURCE, [_P] * 9 + [_I] * 8 + [_P]),
                 "jig_flash_bwd_reduce": (FLASH_BWD_SOURCE, [_P, _P, ctypes.c_longlong, _I, _P])}


def _bind(lib: ctypes.CDLL, name: str):
    """The C entry point `name` of a loaded library, typed."""
    fn = getattr(lib, name)
    fn.argtypes = _ENTRY_POINTS[name][1]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A C entry point of csrc/flash_{fwd,bwd}.cu, built on first use."""
    return _bind(load_library(_ENTRY_POINTS[name][0]), name)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, who: str = "flash_forward") -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"{who} wants (BH, T, D) tensors, got {q.shape}, {k.shape}, {v.shape}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"{who}: mismatched shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    f64_plain = q.dtype == torch.float64 and q.device.type == "cpu"
    if not (q.dtype == k.dtype == v.dtype) or not (q.dtype in _DTYPE_CODES or f64_plain):
        raise TypeError(f"{who} takes bf16 or fp32 q/k/v of one dtype (float64 on the CPU), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{who}: q, k and v must be on one device")
    if q.shape[2] > _MAX_D or min(q.shape) < 1 or min(k.shape) < 1:
        raise ValueError(f"{who}: unsupported shape q={tuple(q.shape)} k={tuple(k.shape)}")


def _check_cuda(who: str, *tensors: torch.Tensor) -> None:
    """What every kernel launch needs beyond `_check`: CUDA, contiguous, and
    32-bit element offsets."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {tensors[0].device}")
    if not all(t.is_contiguous() and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{who}: inputs must be contiguous and on one device")
    if max(t.numel() for t in tensors) >= 2**31:
        raise ValueError(f"{who}: tensors too large for 32-bit indexing: "
                         f"{[tuple(t.shape) for t in tensors]}")


@functools.lru_cache(maxsize=None)
def _cuda_bindings():
    """(current device index, device index -> raw handle of its current
    stream): the bindings PyTorch's own generated kernels call, where they
    exist (no Stream object is made), else the public API."""
    device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return device, raw if raw is not None else (lambda index: torch.cuda.current_stream(index).cuda_stream)


def _call(name: str, args: tuple, device: torch.device, what: str) -> None:
    """Calls the C entry point `name` with `args` and the current stream of
    `device` (made the current device where it is not); raises on an error."""
    index, (current_device, raw_stream) = device.index, _cuda_bindings()
    if index == current_device():
        err = _kernel_fn(name)(*args, raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = _kernel_fn(name)(*args, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} at {what}")


def _launch(name: str, tensors, q: torch.Tensor, k: torch.Tensor, plan) -> None:
    """Calls the kernel entry point `name` with the tensors' pointers (None:
    a null pointer), the shape, the dtype code and the plan's (warpgroups,
    splits, smem_bytes)."""
    bh, tq, d = q.shape
    args = (*(None if t is None else t.data_ptr() for t in tensors), bh, tq, k.shape[1], d,
            _DTYPE_CODES[q.dtype], plan.warpgroups, plan.splits, plan.smem_bytes)
    _call(name, args, q.device, f"q={tuple(q.shape)} k={tuple(k.shape)} {q.dtype}")


def _tma_padded(forward, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """forward(q, k, v) where the kernels' tile loads take the tensors: bf16
    by TMA, rows of a multiple of 16 bytes (D % 8 == 0); fp32 by 16-byte
    cp.async, D % 4 == 0; both 16-byte aligned tensors.  Elsewhere it runs on
    copies padded with zero head columns (a zero column adds nothing to
    q.k^T, and P.V's extra columns are dropped) and O is sliced back; LSE is
    the same."""
    d = q.shape[2]
    mult = 8 if q.dtype == torch.bfloat16 else 4
    if q.dtype not in _DTYPE_CODES or not (d % mult or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        return forward(q, k, v)
    o, lse = forward(*(torch.nn.functional.pad(t, (0, -d % mult)) for t in (q, k, v)))
    return o[..., :d].contiguous(), lse


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    plan = plan_flash_fwd(q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[1], 1), dtype=torch.float32, device=q.device)
    ws_o = ws_ml = None
    if plan.splits > 1:  # the fp32 splits' partial states, for flash_fwd_merge
        ws_o = torch.empty((plan.splits, *q.shape), dtype=torch.float32, device=q.device)
        ws_ml = torch.empty((plan.splits, q.shape[0], q.shape[1], 2), dtype=torch.float32, device=q.device)
    _launch("jig_flash_fwd", (q, k, v, o, lse, ws_o, ws_ml), q, k, plan)
    flash_forward.launches += 1
    if ws_o is not None:
        flash_fwd_merge(ws_o, ws_ml, o, lse)
    return o, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, Tq, D) x (BH, Tk, D) -> (O, LSE (BH, Tq, 1) fp32); q pre-scaled.

    On a CUDA tensor this launches the Hopper kernel on `plan_flash_fwd`'s
    plan (and counts the launch in `flash_forward.launches`; in fp32 where
    the plan splits the key loop, `flash_fwd_merge` then combines the splits)
    or raises; where D % 8 (bf16) or D % 4 (fp32) is not 0, or a view is
    misaligned, it runs on copies padded with zero columns (`_tma_padded`).
    On a CPU tensor it computes the plain version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check_cuda("flash_forward", q, k, v)
    return _tma_padded(_forward_kernel, q, k, v)


counted(flash_forward, launches=0)


def flash_fwd_merge_plain(o_parts: torch.Tensor, ml_parts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fp32 forward's split merge, as the kernel
    sums: from the splits' unnormalised O (splits, BH, Tq, D) and (m, l)
    (splits, BH, Tq, 2), m = max_s m_s, a_s = exp(m_s - m), l = sum_s l_s
    a_s and O = sum_s O_s a_s / l, each sum in split order; returns (O, LSE
    = m + log l (BH, Tq, 1)).  A split that saw no key (m_s = -1e30, l_s =
    0, O_s = 0) adds nothing."""
    m = ml_parts[..., :1].amax(dim=0)
    l = torch.zeros_like(m)
    o = torch.zeros_like(o_parts[0])
    for o_s, ml_s in zip(o_parts, ml_parts):
        a = torch.exp(ml_s[..., :1] - m)
        l = l + ml_s[..., 1:] * a
        o = o + o_s * a
    return o / l, m + torch.log(l)


def flash_fwd_merge(o_parts: torch.Tensor, ml_parts: torch.Tensor, o: torch.Tensor, lse: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combines the fp32 forward's split partial states into o (BH, Tq, D)
    and lse (BH, Tq, 1), fp32, contiguous, D % 4 == 0: o_parts (splits >= 2,
    BH, Tq, D), ml_parts (splits, BH, Tq, 2) as the kernel writes them.  On
    CUDA tensors it launches the merge kernel (and counts the launch in
    `flash_fwd_merge.launches`) or raises; on CPU tensors it computes the
    plain version into o and lse."""
    splits, bh, tq, d = o_parts.shape
    if (any(t.dtype != torch.float32 for t in (o_parts, ml_parts, o, lse)) or splits < 2
            or ml_parts.shape != (splits, bh, tq, 2) or o.shape != (bh, tq, d) or lse.shape != (bh, tq, 1)):
        raise ValueError(f"flash_fwd_merge: o_parts {tuple(o_parts.shape)}, ml_parts {tuple(ml_parts.shape)} do "
                         f"not split o {tuple(o.shape)}, lse {tuple(lse.shape)} (all fp32)")
    if o_parts.device.type == "cpu" and o.device.type == "cpu":
        want_o, want_lse = flash_fwd_merge_plain(o_parts, ml_parts)
        return o.copy_(want_o), lse.copy_(want_lse)
    _check_cuda("flash_fwd_merge", o_parts, ml_parts, o, lse)
    if d % 4 or any(t.data_ptr() % 16 for t in (o_parts, ml_parts, o)):
        raise ValueError(f"flash_fwd_merge: wants D % 4 == 0 and 16-byte aligned tensors, got D = {d}")
    _call("jig_flash_fwd_merge", (o_parts.data_ptr(), ml_parts.data_ptr(), o.data_ptr(), lse.data_ptr(), bh * tq,
                                  d, splits), o.device, f"o_parts={tuple(o_parts.shape)}")
    flash_fwd_merge.launches += 1
    return o, lse


counted(flash_fwd_merge, launches=0)


def _bwd_plan(q: torch.Tensor, k: torch.Tensor, plan: Optional[FlashBwdPlan]) -> FlashBwdPlan:
    return plan_flash_bwd(q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.dtype) if plan is None else plan


def _check_layout(who: str, *tensors: torch.Tensor) -> None:
    """What the kernels' tile loads take (`flash_backward` pads where they do
    not): bf16 by TMA, rows of a multiple of 16 bytes (D % 8 == 0), LSE and
    delta rows starting on 16 bytes (Tq % 4 == 0) and 16-byte aligned
    tensors; fp32 by 16-byte cp.async, D % 4 == 0 and 16-byte aligned q, k,
    v, dO (the first four tensors)."""
    q = tensors[0]
    if q.dtype == torch.bfloat16 and (q.shape[2] % 8 or q.shape[1] % 4 or any(t.data_ptr() % 16 for t in tensors)):
        raise ValueError(f"{who}: bf16 kernels want D % 8 == 0, Tq % 4 == 0 and 16-byte aligned tensors, got "
                         f"q {tuple(q.shape)}")
    if q.dtype == torch.float32 and (q.shape[2] % 4 or any(t.data_ptr() % 16 for t in tensors[:4])):
        raise ValueError(f"{who}: fp32 kernels want D % 4 == 0 and 16-byte aligned q, k, v, dO, got "
                         f"q {tuple(q.shape)}")


def flash_bwd_reduce_plain(ws: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the split reduce: ws[0] + ws[1] + ..., summed
    in that order, as the kernel sums."""
    out = ws[0].clone()
    for part in ws[1:]:
        out += part
    return out


def flash_bwd_reduce(ws: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out = ws[0] + ws[1] + ... in that order: the fp32 kernels' split
    partials, ws (splits >= 2, *out.shape) fp32, out contiguous fp32 with a
    multiple of 4 elements.  On CUDA tensors it launches the reduce kernel
    (and counts the launch in `flash_bwd_reduce.launches`) or raises; on CPU
    tensors it computes the plain version into out."""
    if ws.dtype != torch.float32 or out.dtype != torch.float32 or ws.shape[1:] != out.shape or ws.shape[0] < 2:
        raise ValueError(f"flash_bwd_reduce: ws {tuple(ws.shape)} {ws.dtype} does not split out "
                         f"{tuple(out.shape)} {out.dtype}")
    if ws.device.type == "cpu" and out.device.type == "cpu":
        return out.copy_(flash_bwd_reduce_plain(ws))
    _check_cuda("flash_bwd_reduce", ws, out)
    _call("jig_flash_bwd_reduce", (ws.data_ptr(), out.data_ptr(), out.numel(), ws.shape[0]), out.device,
          f"ws={tuple(ws.shape)}")
    flash_bwd_reduce.launches += 1
    return out


counted(flash_bwd_reduce, launches=0)


def _split_workspace(kp: BwdKernelPlan, out: torch.Tensor) -> Optional[torch.Tensor]:
    """The (splits, *out.shape) fp32 workspace of a split fp32 launch, else None."""
    return torch.empty((kp.splits, *out.shape), dtype=torch.float32, device=out.device) if kp.splits > 1 else None


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                 lse: torch.Tensor, plan: Optional[FlashBwdPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq, delta) from the dq kernel (CUDA tensors only; counts its launches
    in `flash_bwd_dq.launches`): delta = rowsum(dO * O) (BH, Tq, 1) fp32, as
    the kernel computes it for the dkv kernel.  lse: (BH, Tq, 1) fp32.
    `plan` defaults to `plan_flash_bwd`'s; where it splits the fp32 key loop,
    `flash_bwd_reduce` sums the partials."""
    _check_cuda("flash_bwd_dq", q, k, v, o, do, lse)
    _check_layout("flash_bwd_dq", q, k, v, do, o, lse)
    kp = _bwd_plan(q, k, plan).dq
    dq = torch.empty_like(q)
    delta = torch.empty((q.shape[0], q.shape[1], 1), dtype=torch.float32, device=q.device)
    ws = _split_workspace(kp, dq)
    _launch("jig_flash_bwd_dq", (q, k, v, o, do, lse, delta, dq, ws), q, k, kp)
    flash_bwd_dq.launches += 1
    if ws is not None:
        flash_bwd_reduce(ws, dq)
    return dq, delta


counted(flash_bwd_dq, launches=0)


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor, plan: Optional[FlashBwdPlan] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dkv kernel (CUDA tensors only; counts its launches
    in `flash_bwd_dkv.launches`).  lse, delta: (BH, Tq, 1) fp32, delta from
    `flash_bwd_dq`.  fp32: dk and dv are the two halves of one (2, BH, Tk,
    D) buffer, which one `flash_bwd_reduce` fills where the plan splits the q
    loop."""
    _check_cuda("flash_bwd_dkv", q, k, v, do, lse, delta)
    _check_layout("flash_bwd_dkv", q, k, v, do, lse, delta)
    kp = _bwd_plan(q, k, plan).dkv
    if q.dtype == torch.float32:
        dkv = torch.empty((2, *k.shape), dtype=torch.float32, device=k.device)
        dk, dv, ws = dkv[0], dkv[1], _split_workspace(kp, dkv)
    else:
        dkv, ws = None, None
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("jig_flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv, ws), q, k, kp)
    flash_bwd_dkv.launches += 1
    if ws is not None:
        flash_bwd_reduce(ws, dkv)
    return dk, dv


counted(flash_bwd_dkv, launches=0)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the pre-scaled attention, from the forward's O and LSE
    and the output gradient dO (BH, Tq, D).

    On CUDA tensors: the dq kernel (which also writes delta = rowsum(dO * O),
    the rowsum flash_attention.py:315 leaves to XLA), then the dkv kernel,
    both on one `plan_flash_bwd` plan (fp32: each followed by the split
    reduce where the plan splits its loop).  In bf16 where D % 8 or Tq % 4 is
    not 0 (or a view is misaligned) they run on copies padded with zero
    columns and zero q rows (with dO, O and LSE rows 0): a zero column adds
    nothing to any product, and a zero q row has dP = delta = 0, so dS = 0,
    and its dQ row is dropped.  In fp32 where D % 4 is not 0 (or a view is
    misaligned) they run on copies padded with zero columns.  On CPU tensors:
    the plain version."""
    _check(q, k, v, "flash_backward")
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_backward: o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} "
                         f"{do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (q.shape[0], q.shape[1], 1) or lse.dtype != _acc(q):
        raise ValueError(f"flash_backward: lse must be ({q.shape[0]}, {q.shape[1]}, 1) {_acc(q)}, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do)
    _check_cuda("flash_backward", q, k, v, o, lse, do)
    return _bwd_padded(_backward_kernels, q, k, v, o, lse, do)


def _backward_kernels(q, k, v, o, lse, do):
    plan = _bwd_plan(q, k, None)
    dq, delta = flash_bwd_dq(q, k, v, o, do, lse, plan)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, plan))


def _bwd_padded(backward, q, k, v, o, lse, do):
    """backward(q, k, v, o, lse, do) -> (dq, dk, dv) where the kernels' tile
    loads take the tensors (`_check_layout`).  Elsewhere it runs on padded
    copies and the gradients are sliced back: bf16 zero columns to D % 8 == 0
    and zero q rows (dO, O and LSE rows 0) to Tq % 4 == 0, fp32 zero columns
    to D % 4 == 0."""
    tq, d = q.shape[1], q.shape[2]
    pad = torch.nn.functional.pad
    if q.dtype == torch.bfloat16 and (d % 8 or tq % 4 or any(t.data_ptr() % 16 for t in (q, k, v, o, do, lse))):
        q, o, do = (pad(t, (0, -d % 8, 0, -tq % 4)) for t in (q, o, do))
        k, v = (pad(t, (0, -d % 8)) for t in (k, v))
        lse = pad(lse, (0, 0, 0, -tq % 4))
    elif q.dtype == torch.float32 and (d % 4 or any(t.data_ptr() % 16 for t in (q, k, v, do))):
        q, k, v, o, do = (pad(t, (0, -d % 4)) for t in (q, k, v, o, do))
    else:
        return backward(q, k, v, o, lse, do)
    dq, dk, dv = backward(q, k, v, o, lse, do)
    return dq[:, :tq, :d].contiguous(), dk[..., :d].contiguous(), dv[..., :d].contiguous()


class FlashAttention(torch.autograd.Function):
    """O = softmax(q.k^T).v over (BH, T, D), q pre-scaled: the forward kernel,
    with the backward kernels as its gradient (the custom_vjp `_flash`)."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        o, lse = flash_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_backward(q, k, v, o, lse, do.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Tq, D) attention with softmax over Tk; inputs unscaled.  Scales q
    by 1/sqrt(D) in its dtype (flash_attention.py:401) and runs the kernels
    through `FlashAttention`."""
    b, h, tq, d = q.shape
    q = q * (1.0 / math.sqrt(d))
    out = FlashAttention.apply(q.reshape(b * h, tq, d).contiguous(),
                               k.reshape(b * h, -1, d).contiguous(),
                               v.reshape(b * h, -1, d).contiguous())
    return out.reshape(b, h, tq, d)
