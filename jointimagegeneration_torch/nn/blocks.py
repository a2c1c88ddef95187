"""UNet building blocks, channels-last (B, *spatial, C), 2D and 3D.

Counterpart of `jointimagegeneration_tpu/nn/blocks.py` (the unfused paths).
Activations stay channels-last between blocks, so GroupNorm and attention see
the JAX package's layout; each convolution runs on a (B, C, *spatial) view of
the same memory, which is PyTorch's channels_last / channels_last_3d format.

Parameters are fp32 and are cast to the activation dtype per op, as in the
JAX package.  GroupNorm computes in fp32; the timestep projection inside
ResBlock (`emb_out`) is fp32.  ResBlock keeps the JAX package's flat
parameter names (`norm1_scale`, `conv1_kernel`, ...; kernels in PyTorch
layout), so the weight bridge maps names one to one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_self_attention

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
            stride: int = 1) -> torch.Tensor:
    """Zero-padded ('SAME' for stride 1) convolution of a channels-last tensor
    with a (O, I, *k) kernel; computes in x's dtype."""
    dims = x.ndim - 2
    y = _CONV[dims](x.movedim(-1, 1), weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=weight.shape[-1] // 2)
    return y.movedim(1, -1).contiguous()


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
    """Convolution with an odd kernel and k//2 zero padding on channels-last
    input; params fp32, compute in the input dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, dims: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, *(kernel,) * dims, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nd(x, self.weight, self.bias, self.stride)


class Linear(nn.Linear):
    """nn.Linear with fp32 params cast to the input dtype per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


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
    `up` / `down` resample inside the block (nearest 2x / 2x average pool)."""

    def __init__(self, in_ch: int, out_ch: int, emb_ch: int, dims: int,
                 use_scale_shift_norm: bool = False, up: bool = False, down: bool = False,
                 device=None):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.use_scale_shift_norm, self.up, self.down = use_scale_shift_norm, up, down
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

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        emb_out = F.linear(F.silu(emb.float()), self.emb_kernel, self.emb_bias)  # fp32
        h = F.silu(group_norm(x, self.norm1_scale, self.norm1_bias, self.g1))
        if self.up:
            h, x = _nearest_up2(h), _nearest_up2(x)
        elif self.down:
            h, x = _avg_pool2(h), _avg_pool2(x)
        h = conv_nd(h, self.conv1_kernel, self.conv1_bias)
        eo = emb_out.to(h.dtype).reshape(emb_out.shape[:1] + (1,) * (h.ndim - 2) + emb_out.shape[1:])
        if self.use_scale_shift_norm:
            scale, shift = eo.chunk(2, dim=-1)
            h = group_norm(h, self.norm2_scale, self.norm2_bias, self.g2) * (1 + scale) + shift
        else:
            h = group_norm(h + eo, self.norm2_scale, self.norm2_bias, self.g2)
        h = conv_nd(F.silu(h), self.conv2_kernel, self.conv2_bias)
        if self.in_ch != self.out_ch:
            x = conv_nd(x, self.skip_kernel, self.skip_bias)
        return (x + h).to(h.dtype)


class AttentionBlock(nn.Module):
    """Self-attention over the flattened spatial sequence: GN -> qkv ->
    multi-head attention -> proj_out, residual."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 device=None):
        super().__init__()
        self.heads = num_heads if num_head_channels == -1 else max(1, channels // num_head_channels)
        self.norm = GroupNorm32(channels, device=device)
        self.qkv = Linear(channels, 3 * channels, device=device)
        self.proj_out = Linear(channels, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        seq = x.reshape(b, -1, c)
        a = multi_head_self_attention(self.qkv(self.norm(seq)), self.heads)
        return (seq + self.proj_out(a)).reshape(x.shape)
