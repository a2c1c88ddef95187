"""Attention dispatch: the flash kernel for long sequences, plain math otherwise.

Counterpart of `jointimagegeneration_tpu/ops/attention.py`.  Public functions
take channels-last sequences (B, T, C); heads are split as (B, H, T, D).
Sites with Tq >= 512 query tokens whose shape the flash rule accepts go to
`ops.flash_attention.flash_attention` (the Hopper kernels, forward and
backward, on CUDA tensors; their plain versions on CPU tensors); the rest take
the plain path, which scales q and k by d^-1/4 each and takes an fp32
softmax, as the reference does (counted in `plain_attention.launches`, as
the flash kernels count theirs).  Both differentiate on either device.

Under spatial sharding (`parallel/spatial.py`) a shard attends with its own
queries against every key; the rule then reads the site's whole query count
`tq`, as the JAX program sees the global shape, and the kernel runs at the
shard's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention, flash_eligible
from .launch_counters import counted

__all__ = ["plain_attention", "plain_attention_weights", "attention", "multi_head_self_attention", "multi_head_cross_attention",
           "FLASH_MIN_SEQ"]

FLASH_MIN_SEQ = 512


def plain_attention_weights(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The (B, H, Tq, Tk) fp32 softmax weights of `plain_attention`: q and k
    each scaled by d^-1/4, fp32 logits."""
    scale = 1.0 / math.sqrt(math.sqrt(q.shape[-1]))
    logits = torch.matmul((q * scale).float(), (k * scale).float().transpose(-1, -2))
    return torch.softmax(logits, dim=-1)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D); fp32 logits and softmax,
    weights cast to v's dtype for the second product.  Each call counts one
    in `plain_attention.launches`."""
    plain_attention.launches += 1
    return torch.matmul(plain_attention_weights(q, k).to(v.dtype), v)


counted(plain_attention, launches=0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tq: Optional[int] = None) -> torch.Tensor:
    """The flash kernel or the plain path by the rule above; `tq` is the
    site's whole query count (q's own by default)."""
    tq, tk, d = q.shape[2] if tq is None else tq, k.shape[2], q.shape[3]
    if tq >= FLASH_MIN_SEQ and flash_eligible(tq, tk, d):
        return flash_attention(q, k, v)
    return plain_attention(q, k, v)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, heads, c // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def multi_head_self_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """qkv: (B, T, 3C) fused projection, split as [q | k | v] -> (B, T, C)."""
    q, k, v = qkv.chunk(3, dim=-1)
    return _merge_heads(attention(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads)))


def multi_head_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                               tq: Optional[int] = None) -> torch.Tensor:
    """q: (B, Tq, C); k, v: (B, Tk, C) -> (B, Tq, C).  Tq and Tk may differ;
    the flash rule reads both (`tq`: the site's whole query count)."""
    return _merge_heads(attention(_split_heads(q, heads), _split_heads(k, heads), _split_heads(v, heads), tq))
