"""UNet building blocks, channels-last (B, *spatial, C), 2D and 3D.

Counterpart of `jointimagegeneration_tpu/nn/blocks.py`.  Activations stay channels-last between blocks, so GroupNorm and attention see
the JAX package's layout; each convolution runs on a (B, C, *spatial) view of
the same memory, which is PyTorch's channels_last / channels_last_3d format.

Parameters are fp32 and are cast to the activation dtype per op, as in the
JAX package.  GroupNorm computes in fp32; the timestep projection inside
ResBlock (`emb_out`) is fp32.  ResBlock keeps the JAX package's flat
parameter names (`norm1_scale`, `conv1_kernel`, ...; kernels in PyTorch
layout), so the weight bridge maps names one to one, fused or not.

ResBlock's opt-in kernel paths follow the JAX package's rules exactly:
`fused` runs each half of the block as one conv kernel call
(`ops.fused_resblock`) where the block is eligible, and `pallas_conv` routes
single 3x3x3 convs at Cin = 128, H >= 64 to `ops.conv3d.conv3d_3x3_v2`
(`_raw_conv`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_self_attention
from ..ops.conv3d import conv3d_3x3_v2
from ..ops.fused_resblock import (fused_affine_silu_conv3d, fused_conv3d, gn_affine_from_moments,
                                  group_moments, moments_from_channel_sums)

__all__ = [
    "timestep_embedding",
    "group_norm",
    "conv_nd",
    "GroupNorm32",
    "Conv",
    "Linear",
    "ResBlock",
    "AttentionBlock",
    "Upsample",
    "Downsample",
]

_CONV = {2: F.conv2d, 3: F.conv3d}


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings in [cos | sin] order, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-sample GroupNorm of a channels-last tensor, computed in fp32 and
    cast back to x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def conv_nd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            stride: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    """Zero-padded convolution of a channels-last tensor with a (O, I, *k)
    kernel, k//2 on every side unless `padding` says ('SAME' for stride 1);
    computes in x's dtype."""
    dims = x.ndim - 2
    y = _CONV[dims](x.movedim(-1, 1), weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=weight.shape[-1] // 2 if padding is None else padding)
    return y.movedim(1, -1).contiguous()


def _raw_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              pallas: bool = False) -> torch.Tensor:
    """'SAME' conv of a ResBlock's unfused path (nn/blocks.py:97-112 in the
    JAX package): with `pallas`, a 3D 3x3x3 conv at Cin = 128, H >= 64 and
    H % 8 == 0 goes to the conv kernel (`conv3d_3x3_v2`, then + bias in x's
    dtype), every other one to `conv_nd`."""
    dims = x.ndim - 2
    if (pallas and dims == 3 and weight.shape[-1] == 3 and x.shape[-1] == 128 and x.shape[2] >= 64
            and x.shape[2] % 8 == 0):
        y = conv3d_3x3_v2(x, weight.permute(2, 3, 4, 1, 0).to(x.dtype), 8, False)
        return y if bias is None else y + bias.to(y.dtype)
    return conv_nd(x, weight, bias)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x average pool of every spatial axis (odd edges dropped, as a VALID
    window), on the channels-last layout directly."""
    b, *spatial, c = x.shape
    x = x[(slice(None), *(slice(0, s - s % 2) for s in spatial))]
    split = [b] + [n for s in spatial for n in (s // 2, 2)] + [c]
    return x.reshape(split).mean(dim=tuple(range(2, 2 + 2 * len(spatial), 2)))


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    for ax in range(1, x.ndim - 1):
        x = x.repeat_interleave(2, dim=ax)
    return x


class GroupNorm32(nn.Module):
    """GroupNorm with gcd(C, 32) groups, in fp32, output in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.groups = math.gcd(channels, 32)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.groups, self.eps)


class Conv(nn.Module):
    """Convolution with an odd kernel and k//2 zero padding (or `padding`) on
    channels-last input; params fp32, compute in the input dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dims: int, stride: int = 1,
                 padding: Optional[int] = None, use_bias: bool = True, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *(kernel,) * dims, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nd(x, self.weight, self.bias, self.stride, self.padding)


class Linear(nn.Linear):
    """nn.Linear with fp32 params cast to the input dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), None if self.bias is None else self.bias.to(x.dtype))


class Upsample(nn.Module):
    """2x nearest upsample of every spatial axis, then a 3-conv."""

    def __init__(self, channels: int, dims: int, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, dims, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_nearest_up2(x))


class Downsample(nn.Module):
    """Stride-2 3-conv, padding 1."""

    def __init__(self, channels: int, dims: int, device=None):
        super().__init__()
        self.op = Conv(channels, channels, 3, dims, stride=2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class ResBlock(nn.Module):
    """GN -> SiLU -> conv, + timestep embedding (add, or FiLM scale-shift),
    GN -> SiLU -> conv, with a 1x1 skip projection on a channel change.
    `up` / `down` resample inside the block (nearest 2x / 2x average pool).

    `fused` (False | 'xla' | 'kernel' | True) runs the block as two conv
    kernel calls where `can_fuse` holds (3D, no up/down, batch 1, H % 8 == 0;
    the port has no dropout, so the JAX rule's dropout clause always holds):
      * 'kernel' / True: GN1's moments in one pass (`group_moments`) folded
        into a per-channel affine that the kernel applies with SiLU to its
        input; conv1's bias is b1 + emb_out in fp32 and its epilogue emits
        GN2's per-channel sums; conv2 applies GN2 (+ FiLM) the same way and
        adds the residual;
      * 'xla': the name of the JAX package's mode, kept so that each has its
        counterpart.  The prologues silu(GN(x)) and silu(y1 * a2 + s2) are
        plain PyTorch ops (XLA fusions there), and the kernel runs without
        its affine (`fused_conv3d`).
    `pallas_conv` routes the unfused path's convs through `_raw_conv`."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, dims: int,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 pallas_conv: bool = False, fused=False, device=None):
        super().__init__()
        if fused not in (False, True, "xla", "kernel"):
            raise ValueError(f"ResBlock: fused must be False, 'xla', 'kernel' or True, got {fused!r}")
        self.in_ch, self.out_ch, self.dims = in_ch, out_ch, dims
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
        self.pallas_conv, self.fused = pallas_conv, fused
        self.g1, self.g2 = math.gcd(in_ch, 32), math.gcd(out_ch, 32)
        k = (3,) * dims
        p = lambda *shape, fill=0.0: nn.Parameter(torch.full(shape, fill, device=device))
        self.norm1_scale = p(in_ch, fill=1.0)
        self.norm1_bias = p(in_ch)
        self.conv1_kernel = p(out_ch, in_ch, *k)
        self.conv1_bias = p(out_ch)
        emb_features = 2 * out_ch if use_scale_shift_norm else out_ch
        self.emb_kernel = p(emb_features, emb_ch)
        self.emb_bias = p(emb_features)
        self.norm2_scale = p(out_ch, fill=1.0)
        self.norm2_bias = p(out_ch)
        self.conv2_kernel = p(out_ch, out_ch, *k)
        self.conv2_bias = p(out_ch)
        if in_ch != out_ch:
            self.skip_kernel = p(out_ch, in_ch, *(1,) * dims)
            self.skip_bias = p(out_ch)

    def can_fuse(self, x: torch.Tensor) -> bool:
        """The JAX package's eligibility rule (nn/blocks.py:217-224)."""
        return bool(self.fused and self.dims == 3 and not (self.up or self.down) and x.shape[0] == 1
                    and x.shape[2] % 8 == 0)

    def _fused_forward(self, x: torch.Tensor, emb_out: torch.Tensor) -> torch.Tensor:
        n = math.prod(x.shape[1:4])
        dhwio = lambda w: w.permute(2, 3, 4, 1, 0)  # (O, I, 3, 3, 3) -> (3, 3, 3, I, O)
        k1, k2 = dhwio(self.conv1_kernel), dhwio(self.conv2_kernel)
        if self.use_scale_shift_norm:
            film_scale, film_shift = emb_out[0].chunk(2)
            bias1 = self.conv1_bias
        else:
            bias1 = self.conv1_bias + emb_out[0]  # fp32, where the unfused path adds emb in x's dtype
        residual = x if self.in_ch == self.out_ch else conv_nd(x, self.skip_kernel, self.skip_bias)

        def gn2_affine(st: torch.Tensor):
            mean2, var2 = moments_from_channel_sums(st, n, self.g2)
            a2, s2 = gn_affine_from_moments(mean2, var2, self.norm2_scale, self.norm2_bias, self.g2)
            if self.use_scale_shift_norm:
                a2, s2 = a2 * (1 + film_scale), s2 * (1 + film_scale) + film_shift
            return a2, s2

        if self.fused == "xla":
            t1 = F.silu(group_norm(x, self.norm1_scale, self.norm1_bias, self.g1))
            y1, st = fused_conv3d(t1, k1, bias1, None, True)
            a2, s2 = gn2_affine(st)
            t2 = F.silu(y1.float() * a2 + s2).to(y1.dtype)
            return fused_conv3d(t2, k2, self.conv2_bias, residual, False)
        mean1, var1 = group_moments(x, self.g1)
        a1, s1 = gn_affine_from_moments(mean1, var1, self.norm1_scale, self.norm1_bias, self.g1)
        y1, st = fused_affine_silu_conv3d(x, k1, a1, s1, bias1, None, True)
        a2, s2 = gn2_affine(st)
        return fused_affine_silu_conv3d(y1, k2, a2, s2, self.conv2_bias, residual, False)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        emb_out = F.linear(F.silu(emb.float()), self.emb_kernel, self.emb_bias)  # fp32
        if self.can_fuse(x):
            return self._fused_forward(x, emb_out)
        h = F.silu(group_norm(x, self.norm1_scale, self.norm1_bias, self.g1))
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = _raw_conv(h, self.conv1_kernel, self.conv1_bias, self.pallas_conv)
        eo = emb_out.to(h.dtype).reshape(emb_out.shape[:1] + (1,) * (h.ndim - 2) + emb_out.shape[1:])
        if self.use_scale_shift_norm:
            scale, shift = eo.chunk(2, dim=-1)
            h = group_norm(h, self.norm2_scale, self.norm2_bias, self.g2) * (1 + scale) + shift
        else:
            h = group_norm(h + eo, self.norm2_scale, self.norm2_bias, self.g2)
        h = _raw_conv(F.silu(h), self.conv2_kernel, self.conv2_bias, self.pallas_conv)
        if self.in_ch != self.out_ch:
            x = conv_nd(x, self.skip_kernel, self.skip_bias)
        return (x + h).to(h.dtype)


class AttentionBlock(nn.Module):
    """Self-attention over the flattened spatial sequence: GN -> qkv ->
    multi-head attention -> proj_out, residual.  `eps` is the GroupNorm's:
    1e-5 at UNet sites, 1e-6 at VAE sites (`nn.vae.make_attn`)."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.heads = num_heads if num_head_channels == -1 else max(1, channels // num_head_channels)
        self.norm = GroupNorm32(channels, eps=eps, device=device)
        self.qkv = Linear(channels, 3 * channels, device=device)
        self.proj_out = Linear(channels, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        seq = x.reshape(b, -1, c)
        a = multi_head_self_attention(self.qkv(self.norm(seq)), self.heads)
        return (seq + self.proj_out(a)).reshape(x.shape)
