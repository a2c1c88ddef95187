"""Plain fp32 guided-diffusion UNet, 2D and 3D, written from the published
architecture (guided-diffusion's `UNetModel` as the ccdm and latent-diffusion
configs use it), for judging the port.

It imports nothing of the program.  It reads a dict of parameters keyed by the
names and shapes the benchmark makes its weights under (`perfbench.weights`),
which are the names of the program's UNet: `in_conv`, `down_<level>_<i>_res`,
`down_<level>_<i>_attn`, `down_<level>_ds`, `mid_res1`, `mid_attn`,
`mid_res2`, `up_<level>_<i>_res`, `up_<level>_<i>_attn`, `up_<level>_us`,
`out_norm`, `out_conv`.  Inputs and outputs are channels-last (B, *spatial,
C), as the program takes them; inside it runs channels-first.

With a text context (ccdm's `feature_cond_encoder: selfattn`), each attention
site is latent-diffusion's `SpatialTransformer` of one `BasicTransformerBlock`
(GroupNorm, eps 1e-6 -> proj_in -> self-attention, cross-attention over the
context and a GEGLU feed-forward (tanh GELU), each after a LayerNorm (eps
1e-6) with a residual -> proj_out, residual), and the context is GuideGen's
text refiner first (`refiner_forward`: `model_depth` such blocks whose two
attention layers both attend over the features, plus the features as a
residual).

Every product and every stored activation goes through `ops` (`Exact` by
default): the control computes the same graph in a lower precision
(`perfbench.reference.quant`).  Departures from the published model: none at
these configurations (no dropout at inference, no scale-shift norm, no
up/down ResBlocks).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["Exact", "unet_forward", "refiner_forward", "transformer_block", "timestep_embedding", "attention_sites"]


class Exact:
    """fp32 products: convolutions, linear maps and the attention matmuls."""

    def conv(self, x, w, b, stride=1, padding=1):
        return (F.conv2d if x.ndim == 4 else F.conv3d)(x, w, b, stride=stride, padding=padding)

    def linear(self, x, w, b):
        return F.linear(x, w, b)

    def matmul(self, a, b):
        return torch.matmul(a, b)

    def act(self, x):
        """An activation as the torso stores it (between blocks, after a
        residual or embedding add)."""
        return x


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _norm(x, p, prefix_w, prefix_b):
    c = x.shape[1]
    return F.group_norm(x, math.gcd(c, 32), p[prefix_w], p[prefix_b], eps=1e-5)


def _resblock(ops, p, name, x, emb):
    h = F.silu(_norm(x, p, f"{name}.norm1_scale", f"{name}.norm1_bias"))
    h = ops.conv(h, p[f"{name}.conv1_kernel"], p[f"{name}.conv1_bias"])
    e = ops.linear(F.silu(emb), p[f"{name}.emb_kernel"], p[f"{name}.emb_bias"])
    h = ops.act(h + e.reshape(e.shape + (1,) * (h.ndim - 2)))
    h = F.silu(_norm(h, p, f"{name}.norm2_scale", f"{name}.norm2_bias"))
    h = ops.conv(h, p[f"{name}.conv2_kernel"], p[f"{name}.conv2_bias"])
    if f"{name}.skip_kernel" in p:
        x = ops.conv(x, p[f"{name}.skip_kernel"], p[f"{name}.skip_bias"], padding=0)
    return ops.act(x + h)


def _attention(ops, p, name, x, head_channels):
    b, c = x.shape[:2]
    spatial = x.shape[2:]
    h = _norm(x, p, f"{name}.norm.weight", f"{name}.norm.bias").reshape(b, c, -1).transpose(1, 2)
    qkv = ops.linear(h, p[f"{name}.qkv.weight"], p[f"{name}.qkv.bias"])
    heads = max(1, c // head_channels)
    q, k, v = (t.reshape(b, -1, heads, c // heads).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    scale = (c // heads) ** -0.25
    w = torch.softmax(ops.matmul(q * scale, (k * scale).transpose(-1, -2)), dim=-1)
    a = ops.matmul(w, v).transpose(1, 2).reshape(b, -1, c)
    out = ops.linear(a, p[f"{name}.proj_out.weight"], p[f"{name}.proj_out.bias"])
    return ops.act(x + out.transpose(1, 2).reshape(b, c, *spatial))


def _layer_norm(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps=1e-6)


def _mha(ops, p, name, x, context, heads):
    """Multi-head attention of x (B, T, C) over `context` (x itself without
    one): softmax(q k^T / sqrt(d)) v, bias-free q, k, v, then to_out."""
    ctx = x if context is None else context
    q, k, v = (ops.linear(src, p[f"{name}.to_{w}.weight"], None) for w, src in (("q", x), ("k", ctx), ("v", ctx)))
    b, tq, inner = q.shape
    d = inner // heads
    q, k, v = (a.reshape(b, a.shape[1], heads, d).transpose(1, 2) for a in (q, k, v))
    w = torch.softmax(ops.matmul(q * d ** -0.25, (k * d ** -0.25).transpose(-1, -2)), dim=-1)
    out = ops.matmul(w, v).transpose(1, 2).reshape(b, tq, inner)
    return ops.linear(out, p[f"{name}.to_out.weight"], p[f"{name}.to_out.bias"])


def transformer_block(ops, p, name, x, context, heads, dropout=None):
    """latent-diffusion's `BasicTransformerBlock` on x (B, T, C); `dropout`
    (training) is applied to attn1's and attn2's outputs and to the
    feed-forward's hidden layer, in that order."""
    drop = dropout or (lambda a: a)
    x = ops.act(x + drop(_mha(ops, p, f"{name}.attn1", _layer_norm(p, f"{name}.norm1", x), None, heads)))
    x = ops.act(x + drop(_mha(ops, p, f"{name}.attn2", _layer_norm(p, f"{name}.norm2", x), context, heads)))
    a, gate = ops.linear(_layer_norm(p, f"{name}.norm3", x), p[f"{name}.ff.GEGLU_0.Dense_0.weight"],
                         p[f"{name}.ff.GEGLU_0.Dense_0.bias"]).chunk(2, dim=-1)
    h = drop(a * F.gelu(gate, approximate="tanh"))
    return ops.act(x + ops.linear(h, p[f"{name}.ff.Dense_0.weight"], p[f"{name}.ff.Dense_0.bias"]))


def _transformer(ops, p, name, x, head_channels, context):
    b, c = x.shape[:2]
    spatial = x.shape[2:]
    h = F.group_norm(x, math.gcd(c, 32), p[f"{name}.norm.weight"], p[f"{name}.norm.bias"], eps=1e-6)
    h = ops.linear(h.reshape(b, c, -1).transpose(1, 2), p[f"{name}.proj_in.weight"], p[f"{name}.proj_in.bias"])
    h = transformer_block(ops, p, f"{name}.block_0", h, context, max(1, c // head_channels))
    out = ops.linear(h, p[f"{name}.proj_out.weight"], p[f"{name}.proj_out.bias"])
    return ops.act(x + out.transpose(1, 2).reshape(b, c, *spatial))


def refiner_forward(p: Dict[str, torch.Tensor], enc: dict, feats: torch.Tensor, ops=None, dropout=None):
    """The text refiner (`feature_cond_encoder` type selfattn) over raw
    features (B, T, embed_dim), with its parameters under `block_<i>.`."""
    ops = ops or Exact()
    h = feats.float()
    for i in range(enc["model_depth"]):
        h = transformer_block(ops, p, f"block_{i}", h, None, enc["n_heads"], dropout)
    return h + feats.float()


def unet_forward(p: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, t: torch.Tensor,
                 cond: Optional[torch.Tensor] = None, softmax: bool = False, ops=None,
                 context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The UNet's output (channels-last) for input x (B, *spatial, C), the
    timesteps t (B,) and the concatenated condition; `softmax` over the output
    channels for an x0-probability head; with a (refined) text `context`,
    transformer attention sites that cross-attend over it."""
    ops = ops or Exact()
    if context is None:
        site = lambda name, h: _attention(ops, p, name, h, hc)
    else:
        site = lambda name, h: _transformer(ops, p, name, h, hc, context.float())
    mc, mult = cfg["model_channels"], cfg["channel_mult"]
    nrb, attn_res, hc = cfg["num_res_blocks"], cfg["attention_resolutions"], cfg["num_head_channels"]
    emb = timestep_embedding(t, mc)
    emb = ops.linear(F.silu(ops.linear(emb, p["time_embed_0.weight"], p["time_embed_0.bias"])),
                     p["time_embed_1.weight"], p["time_embed_1.bias"])
    if cond is not None:
        x = torch.cat([x, cond.to(x.dtype)], dim=-1)
    h = ops.conv(x.float().movedim(-1, 1), p["in_conv.weight"], p["in_conv.bias"])
    hs, ds = [h], 1
    for level in range(len(mult)):
        for i in range(nrb):
            h = _resblock(ops, p, f"down_{level}_{i}_res", h, emb)
            if ds in attn_res:
                h = site(f"down_{level}_{i}_attn", h)
            hs.append(h)
        if level != len(mult) - 1:
            h = ops.conv(h, p[f"down_{level}_ds.op.weight"], p[f"down_{level}_ds.op.bias"], stride=2)
            hs.append(h)
            ds *= 2
    h = _resblock(ops, p, "mid_res1", h, emb)
    h = site("mid_attn", h)
    h = _resblock(ops, p, "mid_res2", h, emb)
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            h = _resblock(ops, p, f"up_{level}_{i}_res", torch.cat([h, hs.pop()], dim=1), emb)
            if ds in attn_res:
                h = site(f"up_{level}_{i}_attn", h)
            if level and i == nrb:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = ops.conv(h, p[f"up_{level}_us.conv.weight"], p[f"up_{level}_us.conv.bias"])
                ds //= 2
    h = F.silu(_norm(h, p, "out_norm.weight", "out_norm.bias"))
    h = ops.conv(h, p["out_conv.weight"], p["out_conv.bias"])
    if softmax:
        h = torch.softmax(h, dim=1)
    return h.movedim(1, -1)


def attention_sites(cfg: dict, spatial: Sequence[int]) -> list:
    """(tokens, channels) of every attention site of one forward, in order."""
    mult, nrb, attn_res = cfg["channel_mult"], cfg["num_res_blocks"], cfg["attention_resolutions"]
    sites, ds, size = [], 1, list(spatial)
    tokens = lambda: math.prod(size)
    for level, m in enumerate(mult):
        if ds in attn_res:
            sites += [(tokens(), m * cfg["model_channels"])] * nrb
        if level != len(mult) - 1:
            size = [(s + 1) // 2 for s in size]
            ds *= 2
    sites.append((tokens(), mult[-1] * cfg["model_channels"]))
    for level in reversed(range(len(mult))):
        if ds in attn_res:
            sites += [(tokens(), mult[level] * cfg["model_channels"])] * (nrb + 1)
        if level:
            size = [s * 2 for s in size]
            ds //= 2
    return sites
