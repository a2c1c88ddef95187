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

The stock extras of the reference's model.py (`SimpleDecoder`,
`UpsampleDecoder`, `LatentRescaler`, `MergedRescaleEncoder`,
`MergedRescaleDecoder`, `Upsampler`) come over too, with the flax names; no
config uses them.  Torch shapes are not lazy, so each takes the input width
the flax module reads from its input (`in_channels`).  Like every AE here they
compute in fp32 (their weights are fp32 and they cast nothing).

Not ported: dropout, which the sampling path never applies.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import _nearest_index
from .blocks import AttentionBlock, Conv, GroupNorm32, _nearest_up2

__all__ = ["VAEResBlock", "Encoder", "Decoder", "LinearAttentionBlock", "VectorQuantizer", "make_attn",
           "SimpleDecoder", "UpsampleDecoder", "LatentRescaler", "MergedRescaleEncoder", "MergedRescaleDecoder",
           "Upsampler"]


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
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
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
        return self.conv_out(self.norm_out(self._run(x), silu=True))


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
        return self.conv_out(self.norm_out(self._run(z), silu=True))


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


# The stock decoder extras of the reference's model.py (:634-812).


def _out_head(h: torch.Tensor, norm_out: GroupNorm32, conv_out: Conv) -> torch.Tensor:
    return conv_out(norm_out(h, silu=True))


class SimpleDecoder(nn.Module):
    """1x1 conv -> ResBlocks C -> 2C -> 4C -> 2C -> 1x1 conv -> 2x nearest
    upsample + conv -> GN, SiLU, `conv_out`."""

    def __init__(self, in_channels: int, out_channels: int, dims: int = 2, device=None):
        super().__init__()
        c = in_channels
        self.conv_a = Conv(c, c, 1, dims, device=device)
        self.res_1 = VAEResBlock(c, 2 * c, dims, device=device)
        self.res_2 = VAEResBlock(2 * c, 4 * c, dims, device=device)
        self.res_3 = VAEResBlock(4 * c, 2 * c, dims, device=device)
        self.conv_b = Conv(2 * c, c, 1, dims, device=device)
        self.upsample_conv = Conv(c, c, 3, dims, device=device)
        self.norm_out = GroupNorm32(c, eps=1e-6, device=device)
        self.conv_out = Conv(c, out_channels, 3, dims, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_b(self.res_3(self.res_2(self.res_1(self.conv_a(x)))))
        return _out_head(self.upsample_conv(_nearest_up2(h)), self.norm_out, self.conv_out)


class UpsampleDecoder(nn.Module):
    """Per level `num_res_blocks` + 1 ResBlocks to ch * mult, a 2x nearest
    upsample + conv (`up_<level>_conv`) between levels, then GN, SiLU,
    `conv_out`."""

    def __init__(self, in_channels: int, out_channels: int, ch: int, num_res_blocks: int = 2,
                 ch_mult: Sequence[int] = (2, 2), dims: int = 2, device=None):
        super().__init__()
        self.levels = []
        cur = in_channels
        for level, mult in enumerate(ch_mult):
            names = []
            for i in range(num_res_blocks + 1):
                self.add_module(f"res_{level}_{i}", VAEResBlock(cur, ch * mult, dims, device=device))
                names.append(f"res_{level}_{i}")
                cur = ch * mult
            up = None
            if level != len(ch_mult) - 1:
                up = f"up_{level}_conv"
                self.add_module(up, Conv(cur, cur, 3, dims, device=device))
            self.levels.append((names, up))
        self.norm_out = GroupNorm32(cur, eps=1e-6, device=device)
        self.conv_out = Conv(cur, out_channels, 3, dims, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for names, up in self.levels:
            for name in names:
                h = getattr(self, name)(h)
            if up is not None:
                h = getattr(self, up)(_nearest_up2(h))
        return _out_head(h, self.norm_out, self.conv_out)


def _resize_nearest(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Every spatial axis of a channels-last tensor to round(n * factor) by
    jax.image.resize's 'nearest' (source floor((i + 0.5) * n / out), as XLA
    folds it; the reference's F.interpolate default)."""
    for ax in range(1, x.ndim - 1):
        n = x.shape[ax]
        out = int(round(n * factor))
        if out != n:
            x = x.index_select(ax, torch.from_numpy(_nearest_index(n, out)).to(x.device))
    return x


class LatentRescaler(nn.Module):
    """`conv_in` -> `depth` ResBlocks -> nearest resize by `factor` -> one-head
    attention (GN eps 1e-6) -> `depth` ResBlocks -> 1x1 `conv_out`; 2D or 3D."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int, out_channels: int, depth: int = 2,
                 dims: int = 2, device=None):
        super().__init__()
        self.factor, self.depth = factor, depth
        self.conv_in = Conv(in_channels, mid_channels, 3, dims, device=device)
        for i in range(depth):
            self.add_module(f"res1_{i}", VAEResBlock(mid_channels, mid_channels, dims, device=device))
        self.attn = AttentionBlock(mid_channels, num_heads=1, eps=1e-6, device=device)
        for i in range(depth):
            self.add_module(f"res2_{i}", VAEResBlock(mid_channels, mid_channels, dims, device=device))
        self.conv_out = Conv(mid_channels, out_channels, 1, dims, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for i in range(self.depth):
            h = getattr(self, f"res1_{i}")(h)
        h = self.attn(_resize_nearest(h, self.factor))
        for i in range(self.depth):
            h = getattr(self, f"res2_{i}")(h)
        return self.conv_out(h)


class MergedRescaleEncoder(nn.Module):
    """`encoder` (an Encoder without double_z, z = ch * ch_mult[-1]) then
    `rescaler` (a LatentRescaler to `out_ch`)."""

    def __init__(self, in_ch: int, ch: int, out_ch: int, num_res_blocks: int, attn_resolutions: Sequence[int] = (),
                 ch_mult: Sequence[int] = (1, 2, 4, 8), rescale_factor: float = 1.0, rescale_module_depth: int = 1,
                 resolution: int = 256, dims: int = 2, device=None):
        super().__init__()
        mid = ch * ch_mult[-1]
        self.encoder = Encoder(in_channels=in_ch, ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               attn_resolutions=attn_resolutions, z_channels=mid, double_z=False, dims=dims,
                               resolution=resolution, device=device)
        self.rescaler = LatentRescaler(rescale_factor, mid, mid, out_ch, depth=rescale_module_depth, dims=dims,
                                       device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rescaler(self.encoder(x))


class MergedRescaleDecoder(nn.Module):
    """`rescaler` (z_channels -> z_channels * ch_mult[-1]) then `decoder`."""

    def __init__(self, z_channels: int, out_ch: int, ch: int, num_res_blocks: int,
                 attn_resolutions: Sequence[int] = (), ch_mult: Sequence[int] = (1, 2, 4, 8),
                 rescale_factor: float = 1.0, rescale_module_depth: int = 1, resolution: int = 256, dims: int = 2,
                 device=None):
        super().__init__()
        tmp = z_channels * ch_mult[-1]
        self.rescaler = LatentRescaler(rescale_factor, z_channels, tmp, tmp, depth=rescale_module_depth, dims=dims,
                                       device=device)
        self.decoder = Decoder(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                               attn_resolutions=attn_resolutions, z_channels=tmp, out_ch=out_ch, dims=dims,
                               resolution=resolution, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(z))


class Upsampler(nn.Module):
    """`rescaler` (factor 1 + out_size % in_size, mid 2C) then an all-up
    `decoder` of log2(out_size // in_size) + 1 levels of `ch_mult`."""

    def __init__(self, in_size: int, out_size: int, in_channels: int, out_channels: int, ch_mult: int = 2,
                 dims: int = 2, device=None):
        super().__init__()
        if out_size < in_size:
            raise ValueError(f"Upsampler: out_size {out_size} < in_size {in_size}")
        num_blocks = int(math.log2(out_size // in_size)) + 1
        c = in_channels
        self.rescaler = LatentRescaler(1.0 + (out_size % in_size), c, 2 * c, c, dims=dims, device=device)
        self.decoder = Decoder(ch=c, ch_mult=[ch_mult] * num_blocks, num_res_blocks=2, attn_resolutions=(),
                               z_channels=c, out_ch=out_channels, dims=dims, resolution=out_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(x))
