"""Fused ResBlock convs and the GroupNorm <-> affine algebra around them.

Counterpart of `jointimagegeneration_tpu/ops/pallas/fused_resblock.py`.  Each
half of a fused ResBlock is one conv kernel call (`csrc/conv3d.cu`, through
`ops.conv3d`): a SAME 3x3x3 conv with fp32 accumulation, +bias (fp32)
+residual in its epilogue, and optionally the per-channel [sum, sumsq] of its
fp32 output, so the next GroupNorm needs no extra pass over the volume.

  * `fused_affine_silu_conv3d` (mode A) applies the folded GroupNorm affine +
    SiLU to its input inside the kernel, re-zeroing the padding taps;
  * `fused_conv3d` (mode B) takes an input already activated.

Both take channels-last (1, D, H, W, Cin) and a DHWIO (3, 3, 3, Cin, Cout)
kernel, as the JAX package's do; on CPU tensors they compute the plain
version (`fused_conv3d_plain`), on CUDA tensors they launch the kernel or
raise.  Their backward recomputes through the plain version (`_bwd_a`,
`_bwd_b` there).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .conv3d import Out, conv3d_fused, conv3d_plain

__all__ = ["fused_conv3d", "fused_affine_silu_conv3d", "fused_conv3d_plain", "gn_affine_from_moments",
           "group_moments", "moments_from_channel_sums"]


def _check_fused(x: torch.Tensor, tile_h: int, who: str) -> None:
    """The TPU kernel's own limits (fused_resblock.py:128-129): batch 1 and
    H a multiple of its row tile."""
    if x.ndim != 5 or x.shape[0] != 1:
        raise ValueError(f"{who} takes one (1, D, H, W, Cin) volume, got {tuple(x.shape)}")
    if x.shape[2] % tile_h:
        raise ValueError(f"{who}: H ({x.shape[2]}) must be a multiple of tile_h ({tile_h})")


def fused_conv3d_plain(x: torch.Tensor, kernel: torch.Tensor, scale: Optional[torch.Tensor],
                       shift: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                       residual: Optional[torch.Tensor], want_stats: bool, activate: bool = True) -> Out:
    """The plain version of both modes, the counterpart of `_xla_reference`
    (fused_resblock.py:187-207): `activate` applies the silu(x*scale+shift)
    prologue."""
    if not activate:
        scale = shift = None
    return conv3d_plain(x, kernel, scale, shift, bias, residual, want_stats)


def fused_affine_silu_conv3d(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                             shift: torch.Tensor, bias: Optional[torch.Tensor],
                             residual: Optional[torch.Tensor], want_stats: bool = False,
                             tile_h: int = 8) -> Out:
    """conv3x3x3(silu(x*scale+shift)) [+bias] [+residual], channels-last;
    scale, shift: (Cin,) fp32, the folded GroupNorm.  Returns the output in
    x's dtype, plus (2, Cout) fp32 [sum, sumsq] of the fp32 result when
    `want_stats`."""
    _check_fused(x, tile_h, "fused_affine_silu_conv3d")
    return conv3d_fused(x, kernel, scale, shift, bias, residual, want_stats)


def fused_conv3d(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                 residual: Optional[torch.Tensor], want_stats: bool = False, tile_h: int = 8) -> Out:
    """conv3x3x3(x) [+bias] [+residual] with fp32 accumulation and optional
    per-channel moments of the output; x is already activated."""
    _check_fused(x, tile_h, "fused_conv3d")
    return conv3d_fused(x, kernel, None, None, bias, residual, want_stats)


# --- GroupNorm <-> affine algebra ---------------------------------------------

def group_moments(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group (mean, var) of (1, *spatial, C) in fp32, var = E[x^2] - mean^2
    clamped at 0 (one pass, unlike the two-pass `nn.blocks.group_norm`)."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, num_groups, c // num_groups)
    mean = xf.mean(dim=(0, 2))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2)) - mean * mean, 0.0)
    return mean, var


def moments_from_channel_sums(stats: torch.Tensor, n_per_channel: int,
                              num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group (mean, var) from the kernel's per-channel [sum, sumsq] (2, C).
    E[x^2] - mean^2 can cancel slightly negative in fp32, so var is clamped
    at 0, as in the JAX package."""
    c = stats.shape[-1]
    gs = stats.reshape(2, num_groups, c // num_groups).sum(dim=-1)
    n = n_per_channel * (c // num_groups)
    mean = gs[0] / n
    var = torch.clamp_min(gs[1] / n - mean * mean, 0.0)
    return mean, var


def gn_affine_from_moments(mean: torch.Tensor, var: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, num_groups: int,
                           eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold GroupNorm(mean, var) and the per-channel (gamma, beta) into a
    per-channel (scale, shift), fp32."""
    c = gamma.shape[-1]
    rstd = torch.rsqrt(var + eps)
    per_ch = lambda v: v.repeat_interleave(c // num_groups)
    scale = gamma.float() * per_ch(rstd)
    shift = beta.float() - per_ch(mean * rstd) * gamma.float()
    return scale, shift
