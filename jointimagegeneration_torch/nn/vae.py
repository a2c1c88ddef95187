"""VAE encoder / decoder and the vector quantizer, channels-last, 2D and 3D.

Counterpart of the first-stage part of `jointimagegeneration_tpu/nn/vae.py`:
resnet blocks without a timestep input (GroupNorm eps 1e-6, a 1x1
`nin_shortcut` on a channel change), attention placed by the tracked
resolution against `attn_resolutions` plus one mid attention, stride-2
downsampling after an asymmetric (0, 1) pad, nearest x2 upsampling, and the
codebook quantizer of the VQ first stage.  Submodules carry the flax names
(`conv_in`, `down_0_0`, `down_0_0_attn`, `down_0_ds`, `mid_1`, `mid_attn`,
`up_1_us`, `norm_out`, ...), so `utils.jax_weights.ae_state_dict_from_jax`
maps a flax tree onto them by name.

The mid attention of the `_ae` configs has one head of width 384 or 512 over
4,096 tokens.  The flash rule admits no head wider than 256, in the JAX
package as here (`ops.flash_attention.flash_eligible`), so those sites take
the plain attention, the counterpart of the XLA einsum the JAX package runs
there; nothing falls back.

Not ported yet: the stock extras (`SimpleDecoder`, `UpsampleDecoder`,
`LatentRescaler`, `MergedRescale*`, `Upsampler`) and dropout, which the
sampling path never applies.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import AttentionBlock, Conv, GroupNorm32, _nearest_up2

__all__ = ["VAEResBlock", "Encoder", "Decoder", "LinearAttentionBlock", "VectorQuantizer", "make_attn"]


class LinearAttentionBlock(nn.Module):
    """Linear attention: softmax over the token axis of k (in fp32), then
    context = k^T v per head and out = q . context, O(N d e).  As in the
    reference's LinAttnBlock: no bias on the qkv projection, no norm and no
    residual.  Channel order (qkv, heads, dim) in, (heads, dim) out."""

    def __init__(self, channels: int, heads: int = 1, dim_head: Optional[int] = None, dims: int = 2,
                 device=None):
        super().__init__()
        self.heads = heads
        self.dim_head = channels if dim_head is None else dim_head
        hidden = heads * self.dim_head
        self.to_qkv = Conv(channels, 3 * hidden, 1, dims, use_bias=False, device=device)
        self.to_out = Conv(hidden, channels, 1, dims, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, spatial = x.shape[0], x.shape[1:-1]
        n = math.prod(spatial)
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(2)
        k = torch.softmax(k.float(), dim=1).to(x.dtype)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", context, q)
        return self.to_out(out.reshape(b, *spatial, self.heads * self.dim_head))


def make_attn(attn_type: str, channels: int, dims: int, device=None) -> Optional[nn.Module]:
    """'vanilla' (one-head AttentionBlock, GroupNorm eps 1e-6) | 'linear' |
    'none' (no module: the site is the identity)."""
    if attn_type == "vanilla":
        return AttentionBlock(channels, num_heads=1, eps=1e-6, device=device)
    if attn_type == "linear":
        return LinearAttentionBlock(channels, dims=dims, device=device)
    if attn_type == "none":
        return None
    raise ValueError(f"attn_type {attn_type!r} unknown (vanilla|linear|none)")


class VAEResBlock(nn.Module):
    """GN -> SiLU -> conv, twice, with a 1x1 `nin_shortcut` on a channel change."""

    def __init__(self, in_ch: int, out_ch: int, dims: int, device=None):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6, device=device)
        self.conv1 = Conv(in_ch, out_ch, 3, dims, device=device)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6, device=device)
        self.conv2 = Conv(out_ch, out_ch, 3, dims, device=device)
        self.nin_shortcut = Conv(in_ch, out_ch, 1, dims, device=device) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class _Stack(nn.Module):
    """Shared by Encoder and Decoder: blocks added by name, run by name."""

    def _add_attn(self, name: str, attn_type: str, channels: int, dims: int, device) -> None:
        module = make_attn(attn_type, channels, dims, device)
        if module is not None:
            self._add(name, module)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.order.append(name)

    def _run(self, h: torch.Tensor) -> torch.Tensor:
        for name in self.order:
            if name.endswith("_ds"):  # asymmetric (0, 1) pad, then the VALID stride-2 conv
                h = F.pad(h, (0, 0) + (0, 1) * (h.ndim - 2))
            elif name.endswith("_us"):
                h = _nearest_up2(h)
            h = getattr(self, name)(h)
        return h


class Encoder(_Stack):
    """(B, *S, in_channels) -> (B, *S / 2^(L-1), 2 z_channels, or z_channels
    without `double_z`).  Attention goes where the tracked resolution (from
    `resolution`, halved at each downsample) is in `attn_resolutions`."""

    def __init__(self, in_channels: int = 1, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (), z_channels: int = 4,
                 double_z: bool = True, dims: int = 2, resolution: int = 256, attn_type: str = "vanilla",
                 device=None):
        super().__init__()
        self.order = []
        self._add("conv_in", Conv(in_channels, ch, 3, dims, device=device))
        cur, res = ch, resolution
        for level, mult in enumerate(ch_mult):
            for i in range(num_res_blocks):
                self._add(f"down_{level}_{i}", VAEResBlock(cur, ch * mult, dims, device=device))
                cur = ch * mult
                if res in attn_resolutions:
                    self._add_attn(f"down_{level}_{i}_attn", attn_type, cur, dims, device)
            if level != len(ch_mult) - 1:
                self._add(f"down_{level}_ds", Conv(cur, cur, 3, dims, stride=2, padding=0, device=device))
                res //= 2
        self._add("mid_1", VAEResBlock(cur, cur, dims, device=device))
        self._add_attn("mid_attn", attn_type, cur, dims, device)
        self._add("mid_2", VAEResBlock(cur, cur, dims, device=device))
        self.norm_out = GroupNorm32(cur, eps=1e-6, device=device)
        self.conv_out = Conv(cur, 2 * z_channels if double_z else z_channels, 3, dims, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(F.silu(self.norm_out(self._run(x))))


class Decoder(_Stack):
    """(B, *S, z_channels) -> (B, *S * 2^(L-1), out_ch); attention placed as
    in the Encoder, the resolution tracked up from resolution / 2^(L-1)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), z_channels: int = 4, out_ch: int = 1, dims: int = 2,
                 resolution: int = 256, attn_type: str = "vanilla", device=None):
        super().__init__()
        self.order = []
        res = resolution // 2 ** (len(ch_mult) - 1)
        cur = ch * ch_mult[-1]
        self._add("conv_in", Conv(z_channels, cur, 3, dims, device=device))
        self._add("mid_1", VAEResBlock(cur, cur, dims, device=device))
        self._add_attn("mid_attn", attn_type, cur, dims, device)
        self._add("mid_2", VAEResBlock(cur, cur, dims, device=device))
        for level, mult in reversed(list(enumerate(ch_mult))):
            for i in range(num_res_blocks + 1):
                self._add(f"up_{level}_{i}", VAEResBlock(cur, ch * mult, dims, device=device))
                cur = ch * mult
                if res in attn_resolutions:
                    self._add_attn(f"up_{level}_{i}_attn", attn_type, cur, dims, device)
            if level != 0:
                self._add(f"up_{level}_us", Conv(cur, cur, 3, dims, device=device))
                res *= 2
        self.norm_out = GroupNorm32(cur, eps=1e-6, device=device)
        self.conv_out = Conv(cur, out_ch, 3, dims, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.conv_out(F.silu(self.norm_out(self._run(z))))


class VectorQuantizer(nn.Module):
    """Nearest-codebook quantizer with the straight-through estimator.
    Returns (zq, beta * commitment + codebook loss, indices)."""

    def __init__(self, n_embed: int = 8192, embed_dim: int = 4, beta: float = 0.25, device=None):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.codebook = nn.Parameter(torch.zeros(n_embed, embed_dim, device=device))

    def forward(self, z: torch.Tensor):
        cb = self.codebook.to(z.dtype)
        flat = z.reshape(-1, self.embed_dim)
        d = (flat ** 2).sum(-1, keepdim=True) - 2 * flat @ cb.T + (cb ** 2).sum(-1)[None]
        idx = torch.argmin(d, dim=-1)
        zq = cb[idx].reshape(z.shape)
        loss = self.beta * torch.mean((zq.detach() - z) ** 2) + torch.mean((zq - z.detach()) ** 2)
        return z + (zq - z).detach(), loss, idx.reshape(z.shape[:-1])
