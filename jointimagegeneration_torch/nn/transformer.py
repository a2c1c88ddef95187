"""Cross-attention transformer blocks over flattened sequences, channels-last.

Counterpart of `jointimagegeneration_tpu/nn/transformer.py`: `GEGLU`,
`FeedForward`, `CrossAttention`, `BasicTransformerBlock` and
`SequenceTransformer` (GroupNorm -> proj_in -> blocks -> zero proj_out,
residual) over a (B, *spatial, C) input of any spatial rank, so one module
serves the 3D stage-1 UNet sites and the text refiner's (B, T, D) features.

Where a direct translation of the flax modules would go wrong:
  * flax's `nn.gelu` is the tanh approximation (`F.gelu(approximate="tanh")`);
  * flax's LayerNorm takes epsilon 1e-6 (torch's default is 1e-5); the blocks
    compute it in fp32 and cast back to the activation dtype;
  * the SequenceTransformer's GroupNorm takes eps 1e-6, not the UNet's 1e-5;
  * `to_q`, `to_k` and `to_v` have no bias, `to_out` has one; `proj_out` is
    zero-initialised (`nn.unet.ZERO_INIT_SUFFIXES`);
  * GEGLU splits its projection as [a | gate] and returns a * gelu(gate).

Submodules carry the flax names, FeedForward's the auto-names
(`ff.GEGLU_0.Dense_0`, `ff.Dense_0`), so `utils.jax_weights` maps a flax tree
by name.  Dropout follows flax's `nn.Dropout`: in training (a `noise` source
given) each value is kept with probability 1 - p, the kept ones scaled by
1 / (1 - p); the masks come from the `NoiseSource` in the order the forward
meets them (a block's attn1 output, attn2 output, then the feed-forward's
hidden layer).  They cannot replay flax's per-module dropout keys.

Every block takes a `Sharded` input (`parallel/spatial.py`: the UNet's
'model' axis, the tokens of a spatially sharded site): LayerNorm, the
projections and the feed-forward run shard by shard; a self-attention
(`attn1`, or `attn2` without a context) gathers every shard's keys and
values and dispatches on the site's whole query count; a cross-attention
over the replicated context stays on each shard; a dropout mask is drawn
for the whole tensor and cut like it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_cross_attention
from ..parallel import spatial
from ..parallel.spatial import Sharded, each
from .blocks import GroupNorm32, Linear

__all__ = ["dropout", "LayerNorm", "GEGLU", "FeedForward", "CrossAttention", "BasicTransformerBlock",
           "SequenceTransformer"]


def dropout(x, rate: float, noise=None):
    """flax `nn.Dropout(rate)`: the identity without a noise source (sampling,
    validation); else keep where a uniform draw < 1 - rate, scaled by
    1 / (1 - rate), zero elsewhere.  A `Sharded` x draws its whole shape."""
    if noise is None or rate <= 0.0:
        return x
    if rate >= 1.0:
        return each(torch.zeros_like, x)
    keep_prob = 1.0 - rate
    keep = noise.uniform(x.shape) < keep_prob
    keep = spatial.split(keep, x.devices) if isinstance(x, Sharded) else keep.to(x.device)
    return each(lambda a, k: torch.where(k, a / keep_prob, torch.zeros_like(a)), x, keep)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` (epsilon 1e-6, scale and bias) in fp32, the output
    cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.to(x.device), self.bias.to(x.device),
                            self.eps).to(x.dtype)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, device=None):
        super().__init__()
        self.Dense_0 = Linear(dim_in, 2 * dim_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.Dense_0(x).chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU to `mult` x dim, dropout, back to dim (the JAX blocks' glu=True)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, device=None):
        super().__init__()
        self.rate = dropout
        self.GEGLU_0 = GEGLU(dim, dim * mult, device=device)
        self.Dense_0 = Linear(dim * mult, dim, device=device)

    def forward(self, x, noise=None):
        return each(self.Dense_0, dropout(each(self.GEGLU_0, x), self.rate, noise))


class CrossAttention(nn.Module):
    """Multi-head attention of x over `context` (self-attention without
    one), back to x's width.  `context_dim` is the context's width (x's by
    default)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 context_dim: Optional[int] = None, device=None):
        super().__init__()
        inner, ctx = heads * dim_head, context_dim or query_dim
        self.heads, self.rate = heads, dropout
        self.to_q = Linear(query_dim, inner, bias=False, device=device)
        self.to_k = Linear(ctx, inner, bias=False, device=device)
        self.to_v = Linear(ctx, inner, bias=False, device=device)
        self.to_out = Linear(inner, query_dim, device=device)

    def forward(self, x, context: Optional[torch.Tensor] = None, noise=None):
        ctx = x if context is None else context
        q, k, v = each(self.to_q, x), each(self.to_k, ctx), each(self.to_v, ctx)
        if isinstance(k, Sharded):  # self-attention: every shard's keys and values
            k, v = spatial.gather_tokens(k), spatial.gather_tokens(v)
        tq = x.shape[1] if isinstance(x, Sharded) else None
        out = each(lambda q_, k_, v_: multi_head_cross_attention(q_, k_, v_, self.heads, tq), q, k, v)
        return dropout(each(self.to_out, out), self.rate, noise)


class BasicTransformerBlock(nn.Module):
    """Self-attention -> cross-attention over the context -> feed-forward,
    each pre-LayerNorm with a residual.  `attn1` attends over the context
    too when `disable_self_attn`; `attn2` is self-attention when no context
    is given."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False, device=None):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.norm1 = LayerNorm(dim, device=device)
        self.attn1 = CrossAttention(dim, heads, dim_head, dropout, context_dim if disable_self_attn else None,
                                    device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.attn2 = CrossAttention(dim, heads, dim_head, dropout, context_dim, device=device)
        self.norm3 = LayerNorm(dim, device=device)
        self.ff = FeedForward(dim, dropout=dropout, device=device)

    def forward(self, x, context: Optional[torch.Tensor] = None, noise=None):
        x = each(torch.add, x, self.attn1(each(self.norm1, x), context if self.disable_self_attn else None, noise))
        x = each(torch.add, x, self.attn2(each(self.norm2, x), context, noise))
        return each(torch.add, x, self.ff(each(self.norm3, x), noise))


class SequenceTransformer(nn.Module):
    """GroupNorm (eps 1e-6) -> proj_in -> `depth` transformer blocks -> zero
    proj_out, residual, over the flattened spatial sequence of a (B,
    *spatial, C) input."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1, dropout: float = 0.0,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False, device=None):
        super().__init__()
        inner = heads * dim_head
        self.depth = depth
        self.norm = GroupNorm32(channels, eps=1e-6, device=device)
        self.proj_in = Linear(channels, inner, device=device)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(inner, heads, dim_head, dropout, context_dim,
                                                                disable_self_attn, device=device))
        self.proj_out = Linear(inner, channels, device=device)

    def forward(self, x, context: Optional[torch.Tensor] = None, noise=None):
        b, c = x.shape[0], x.shape[-1]
        h = each(lambda n: self.proj_in(n.reshape(b, -1, c)), self.norm(x))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context, noise)
        return each(lambda p, o: p + self.proj_out(o).reshape(p.shape), x, h)
