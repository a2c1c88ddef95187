"""Device kernels by kind, from their names.

Frozen copy of `TRACE_KINDS` and `kind_of` in
`jointimagegeneration_torch/core/logging.py`: the first pattern that matches
a kernel's name gives its kind; a kernel that matches none is 'other'.
"""

from __future__ import annotations

import re

__all__ = ["TRACE_KINDS", "kind_of"]

TRACE_KINDS = [
    ("conv3d_kernel", r"conv3d_wgmma_kernel|conv3d_ffma_kernel|splitk_reduce_kernel|stats_reduce_kernel"),
    ("flash_fwd", r"flash_fwd"),
    ("flash_bwd", r"flash_bwd|delta_f32_kernel|splits_reduce_f32_kernel"),
    ("optimizer", r"multi_tensor_apply|foreach|adam"),
    ("conv", r"xmma_fprop|implicit_gemm|conv|cudnn|wgrad|dgrad"),
    ("matmul", r"gemm|cutlass|cublas"),
    ("norm_reduce", r"reduce_kernel|welford"),
    ("copy_cast", r"copy_kernel|catarray|cat_batched"),
    ("elementwise", r"elementwise|silu|softmax|index"),
]
_COMPILED = [(kind, re.compile(pat, re.IGNORECASE)) for kind, pat in TRACE_KINDS]


def kind_of(name: str) -> str:
    for kind, pat in _COMPILED:
        if pat.search(name):
            return kind
    return "other"
