"""Plain fp32 KL autoencoder (latent-diffusion's `AutoencoderKL` with the
taming `Encoder` and `Decoder`, as GuideGen's `_ae` configs use them), for
judging the port.

It imports nothing of the program.  It reads a dict of parameters keyed by the
program's state-dict names (`encoder.conv_in`, `encoder.down_<level>_<i>`
with `norm1`, `conv1`, `norm2`, `conv2` and, on a channel change,
`nin_shortcut`, `encoder.down_<level>_<i>_attn`, `encoder.down_<level>_ds`,
`encoder.mid_1`, `encoder.mid_attn`, `encoder.mid_2`, `encoder.norm_out`,
`encoder.conv_out`, `quant_conv`, `post_quant_conv`, `decoder.conv_in`, the
decoder's mid blocks, `decoder.up_<level>_<i>`, `decoder.up_<level>_<i>_attn`,
`decoder.up_<level>_us`, `decoder.norm_out`, `decoder.conv_out`) and an AE
section as the configuration gives it (`embed_dim` and the `ddconfig` keys).
Inputs and outputs are channels-last (B, H, W, C), as the program takes them;
inside it runs channels-first, one op at a time.

The published blocks: GroupNorm of 32 groups (gcd(C, 32) at the tests'
small widths), eps 1e-6, its variance in two passes (the mean, then the
mean of the squared deviations); SiLU; a ResBlock
is norm1, SiLU, conv1, norm2, SiLU, conv2, with a 1x1 `nin_shortcut` on a
channel change, and the residual; attention goes where the resolution,
tracked from `resolution` and halved at each downsample, is in
`attn_resolutions`, plus one in the middle: GroupNorm, q, k, v, softmax(q k^T
/ sqrt(C)) v over the H W tokens in one head, proj_out, the residual; a
downsample pads (0, 1) on the right of each spatial axis and convolves 3x3
at stride 2 without padding; an upsample repeats each pixel 2x2 (nearest)
and convolves 3x3.  `encode` returns the posterior's mode (the first
`embed_dim` channels of `quant_conv`'s moments), `decode` runs
`post_quant_conv` then the decoder.

Every product and every stored activation goes through `ops` (`Exact` by
default), as in `reference.unet`: the control computes the same graph in a
lower precision.  Departures from the published model: q, k and v are one
(3C, C) linear map over the tokens where the published block has three 1x1
convolutions (the same products; the program keeps them as one `qkv`
matrix, split as [q | k | v]); the sampling path applies no dropout.  The
caller sets TF32 off (`reference.exact_fp32`).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .unet import Exact

__all__ = ["encode", "decode", "group_norm", "attention"]


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of gcd(C, 32) groups (32 at every published width) of x
    (B, C, ...), the variance in two passes."""
    b, c = x.shape[:2]
    h = x.reshape(b, math.gcd(c, 32), -1)
    mean = h.mean(dim=-1, keepdim=True)
    var = ((h - mean) ** 2).mean(dim=-1, keepdim=True)
    h = ((h - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    return h * weight.reshape(shape) + bias.reshape(shape)


def _conv(ops, p, name, x, padding=1, stride=1):
    return ops.conv(x, p[f"{name}.weight"], p[f"{name}.bias"], stride=stride, padding=padding)


def _resblock(ops, p, name, x):
    h = _conv(ops, p, f"{name}.conv1", F.silu(group_norm(x, p[f"{name}.norm1.weight"], p[f"{name}.norm1.bias"])))
    h = _conv(ops, p, f"{name}.conv2", F.silu(group_norm(h, p[f"{name}.norm2.weight"], p[f"{name}.norm2.bias"])))
    if f"{name}.nin_shortcut.weight" in p:
        x = _conv(ops, p, f"{name}.nin_shortcut", x, padding=0)
    return ops.act(x + h)


def attention(ops, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    """The one-head attention block `name` on x (B, C, H, W)."""
    b, c = x.shape[:2]
    h = group_norm(x, p[f"{name}.norm.weight"], p[f"{name}.norm.bias"]).reshape(b, c, -1).transpose(1, 2)
    q, k, v = ops.linear(h, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"]).chunk(3, dim=-1)
    w = torch.softmax(ops.matmul(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
    out = ops.linear(ops.matmul(w, v), p[f"{name}.proj_out.weight"], p[f"{name}.proj_out.bias"])
    return ops.act(x + out.transpose(1, 2).reshape(x.shape))


def _dd(section: dict) -> dict:
    return section["ddconfig"]


def encode(p: Dict[str, torch.Tensor], section: dict, x: torch.Tensor, ops=None) -> torch.Tensor:
    """The posterior's mode (B, H / f, W / f, embed_dim) of x (B, H, W, in_channels)."""
    ops = ops or Exact()
    dd = _dd(section)
    mult, nrb = dd["ch_mult"], dd["num_res_blocks"]
    h = _conv(ops, p, "encoder.conv_in", x.float().movedim(-1, 1))
    res = dd["resolution"]
    for level in range(len(mult)):
        for i in range(nrb):
            h = _resblock(ops, p, f"encoder.down_{level}_{i}", h)
            if res in dd["attn_resolutions"]:
                h = attention(ops, p, f"encoder.down_{level}_{i}_attn", h)
        if level != len(mult) - 1:
            h = _conv(ops, p, f"encoder.down_{level}_ds", F.pad(h, (0, 1, 0, 1)), padding=0, stride=2)
            res //= 2
    h = _resblock(ops, p, "encoder.mid_1", h)
    h = attention(ops, p, "encoder.mid_attn", h)
    h = _resblock(ops, p, "encoder.mid_2", h)
    h = F.silu(group_norm(h, p["encoder.norm_out.weight"], p["encoder.norm_out.bias"]))
    moments = _conv(ops, p, "quant_conv", _conv(ops, p, "encoder.conv_out", h), padding=0)
    return moments[:, :section["embed_dim"]].movedim(1, -1)


def decode(p: Dict[str, torch.Tensor], section: dict, z: torch.Tensor, ops=None) -> torch.Tensor:
    """The image (B, H f, W f, out_ch) of a latent z (B, H, W, embed_dim)."""
    ops = ops or Exact()
    dd = _dd(section)
    mult, nrb = dd["ch_mult"], dd["num_res_blocks"]
    h = _conv(ops, p, "post_quant_conv", z.float().movedim(-1, 1), padding=0)
    h = _conv(ops, p, "decoder.conv_in", h)
    h = _resblock(ops, p, "decoder.mid_1", h)
    h = attention(ops, p, "decoder.mid_attn", h)
    h = _resblock(ops, p, "decoder.mid_2", h)
    res = dd["resolution"] // 2 ** (len(mult) - 1)
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            h = _resblock(ops, p, f"decoder.up_{level}_{i}", h)
            if res in dd["attn_resolutions"]:
                h = attention(ops, p, f"decoder.up_{level}_{i}_attn", h)
        if level:
            h = _conv(ops, p, f"decoder.up_{level}_us", F.interpolate(h, scale_factor=2, mode="nearest"))
            res *= 2
    h = F.silu(group_norm(h, p["decoder.norm_out.weight"], p["decoder.norm_out.bias"]))
    return _conv(ops, p, "decoder.conv_out", h).movedim(1, -1)
