"""Flash-attention forward: the Hopper kernel, its wrapper and its plain version.

Counterpart of `jointimagegeneration_tpu/ops/pallas/flash_attention.py`.  The
kernel (`csrc/flash_fwd.cu`) replaces that file's forward kernels
(`_flash_kernel_unrolled`, `_flash_kernel`, `_flash_kernel_pipelined`, entered
through `_flash_forward`): O = softmax(q.k^T).v with an online softmax in fp32,
plus the fp32 logsumexp.  Its source comment gives the bound and the design.

Layout is the JAX package's: (BH, T, D), q already scaled by 1/sqrt(D), and
`flash_attention` takes (B, H, T, D) and does the scaling.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from .cuda.build import load_library

__all__ = ["flash_forward", "flash_attention_plain", "flash_attention", "flash_eligible",
           "FLASH_SOURCE"]

FLASH_SOURCE = "flash_fwd"
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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (BH, Tq, D) x (BH, Tk, D) ->
    (O (BH, Tq, D) in q's dtype, LSE (BH, Tq, 1) fp32); q pre-scaled.  Scores
    and softmax in fp32, P rounded to v's dtype for P.V, as the kernel does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), m + torch.log(l)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of csrc/flash_fwd.cu, built on first use."""
    fn = load_library(FLASH_SOURCE).jig_flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"flash_forward wants (BH, T, D) tensors, got {q.shape}, {k.shape}, {v.shape}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_forward: mismatched shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_forward takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_forward: q, k and v must be on one device")
    if q.shape[2] > _MAX_D or min(q.shape) < 1 or min(k.shape) < 1:
        raise ValueError(f"flash_forward: unsupported shape q={tuple(q.shape)} k={tuple(k.shape)}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, Tq, D) x (BH, Tk, D) -> (O, LSE (BH, Tq, 1) fp32); q pre-scaled.

    On a CUDA tensor this launches the Hopper kernel (and counts the launch in
    `flash_forward.launches`) or raises; on a CPU tensor it computes the plain
    version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward: no kernel for device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_forward: q, k and v must be contiguous")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if bh * max(tq, tk) * d >= 2**31:
        raise ValueError(f"flash_forward: tensors too large for 32-bit indexing: {tuple(q.shape)}")
    fn = _kernel_fn()
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 bh, tq, tk, d, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err} at "
                           f"q={tuple(q.shape)} k={tuple(k.shape)} {q.dtype}")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Tq, D) attention with softmax over Tk; inputs unscaled.  Scales q
    by 1/sqrt(D) in its dtype (flash_attention.py:401) and runs the kernel."""
    b, h, tq, d = q.shape
    q = q * (1.0 / math.sqrt(d))
    out, _ = flash_forward(q.reshape(b * h, tq, d).contiguous(),
                           k.reshape(b * h, -1, d).contiguous(),
                           v.reshape(b * h, -1, d).contiguous())
    return out.reshape(b, h, tq, d)
