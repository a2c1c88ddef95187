"""Flash attention: the Hopper kernels, their wrappers, their plain versions
and the autograd Function that joins them.

Counterpart of `jointimagegeneration_tpu/ops/pallas/flash_attention.py`.
  * Forward (`csrc/flash_fwd.cu`, wrapper `flash_forward`) replaces that
    file's forward kernels (`_flash_kernel_unrolled`, `_flash_kernel`,
    `_flash_kernel_pipelined`, entered through `_flash_forward`): O =
    softmax(q.k^T).v with an online softmax in fp32, plus the fp32 logsumexp.
  * Backward (`csrc/flash_bwd.cu`, wrappers `flash_bwd_dkv` and `flash_bwd_dq`,
    joined by `flash_backward`) replaces `_bwd_dkv_kernel` and
    `_bwd_dq_kernel` (entered through `_flash_backward`): dK, dV and dQ
    recomputed from the saved LSE, with delta = rowsum(dO * O) computed
    outside the kernels.
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
from typing import Tuple

import torch

from .cuda.build import load_library

__all__ = ["flash_forward", "flash_attention_plain", "flash_backward", "flash_backward_plain",
           "flash_bwd_dkv", "flash_bwd_dq", "FlashAttention", "flash_attention", "flash_eligible",
           "FLASH_SOURCE", "FLASH_BWD_SOURCE"]

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


# C entry point -> (source under csrc/, number of pointer arguments); each also
# takes (bh, tq, tk, d, dtype code) as ints and the stream as a pointer
_ENTRY_POINTS = {"jig_flash_fwd": (FLASH_SOURCE, 5), "jig_flash_bwd_dkv": (FLASH_BWD_SOURCE, 8),
                 "jig_flash_bwd_dq": (FLASH_BWD_SOURCE, 7)}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """A C entry point of csrc/flash_{fwd,bwd}.cu, built on first use."""
    source, n_ptr = _ENTRY_POINTS[name]
    fn = getattr(load_library(source), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def _launch(name: str, tensors, q: torch.Tensor, k: torch.Tensor) -> None:
    bh, tq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_fn(name)(*(t.data_ptr() for t in tensors), bh, tq, k.shape[1], d,
                               _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} at "
                           f"q={tuple(q.shape)} k={tuple(k.shape)} {q.dtype}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, Tq, D) x (BH, Tk, D) -> (O, LSE (BH, Tq, 1) fp32); q pre-scaled.

    On a CUDA tensor this launches the Hopper kernel (and counts the launch in
    `flash_forward.launches`) or raises; on a CPU tensor it computes the plain
    version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check_cuda("flash_forward", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[1], 1), dtype=torch.float32, device=q.device)
    _launch("jig_flash_fwd", (q, k, v, o, lse), q, k)
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dkv kernel (CUDA tensors only; counts its launches in
    `flash_bwd_dkv.launches`).  lse, delta: (BH, Tq, 1) fp32."""
    _check_cuda("flash_bwd_dkv", q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("jig_flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q, k)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                 lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """dq from the dq kernel (CUDA tensors only; counts its launches in
    `flash_bwd_dq.launches`)."""
    _check_cuda("flash_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("jig_flash_bwd_dq", (q, k, v, do, lse, delta, dq), q, k)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                   lse: torch.Tensor, do: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the pre-scaled attention, from the forward's O and LSE
    and the output gradient dO (BH, Tq, D).

    On CUDA tensors: delta = rowsum(dO * O) in fp32 (two torch ops, as
    flash_attention.py:315 leaves it outside the kernels), then the dkv and dq
    kernels; on CPU tensors: the plain version."""
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
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    return dq, dk, dv


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
