"""The plain references that decide `correct`; they import nothing of the
program."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["exact_fp32"]


@contextlib.contextmanager
def exact_fp32():
    """fp32 products as written: TF32 off in matrix products and cuDNN
    convolutions, whatever the program set; restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
