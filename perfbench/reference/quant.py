"""The control: the reference's products in fp8, the precision below the
bf16 that the configurations state.

Each operand of a convolution, a linear map or an attention matmul, its
result, and the torso's activations after each residual and embedding add
are rounded to float8_e4m3fn under one scale per tensor (its largest
magnitude maps to 448, e4m3's largest finite value) and computed on in fp32:
an fp8 torso, where the program's is bf16.  In a train step every gradient
that flows back through one of those roundings is rounded to float8_e5m2
under its own per-tensor scale (fp8 training's format for gradients), so the
backward's products take fp8 operands too, where the program's take bf16.
Norms and softmax compute in fp32 from the rounded values, as the program's
do from bf16; the sampler's and the loss's arithmetic stay in fp32.
"""

from __future__ import annotations

import torch

from .unet import Exact

__all__ = ["Fp8", "to_fp8"]

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().float().clamp_min(1e-30) / top
    return (t.float() / scale).to(dtype).float() * scale


class _GradFp8(torch.autograd.Function):
    """The identity, whose incoming gradient is rounded to e5m2 under a
    per-tensor scale (fp8 training's format for gradients)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 under a per-tensor scale, returned in fp32.  Under
    autograd the gradient that flows back through the rounding is itself
    rounded to e5m2: the backward's products and stored gradients are fp8
    too."""
    rounded = _round(t.detach(), torch.float8_e4m3fn, E4M3_MAX)
    return _GradFp8.apply(t + (rounded - t).detach()) if t.requires_grad else rounded


class Fp8(Exact):
    def conv(self, x, w, b, stride=1, padding=1):
        return to_fp8(super().conv(to_fp8(x), to_fp8(w), b, stride, padding))

    def linear(self, x, w, b):
        return to_fp8(super().linear(to_fp8(x), to_fp8(w), b))

    def matmul(self, a, b):
        return to_fp8(super().matmul(to_fp8(a), to_fp8(b)))

    def act(self, x):
        return to_fp8(x)
