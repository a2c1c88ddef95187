"""Text conditioning encoders.

Counterparts of the stage-1 text encoders of
`jointimagegeneration_tpu/nn/text.py`:
  * `TextFeatureRefiner`: the trainable refiner over precomputed BERT
    features, `depth` BasicTransformerBlocks called without a context (so
    both `attn1` and `attn2` are self-attention), plus the input as a
    residual;
  * `FrozenBERTEmbedder`: a frozen Hugging Face BERT read from a local model
    directory, with the long-report chunking at `max_length` tokens and the
    zero padding to the longest text.  `transformers` is imported only when
    one is built;
  * `IdentityEncoder`: the passthrough;
and of its stage-2 conditioners:
  * `TransformerTextEncoder`: token and learned position embeddings, `depth`
    self-attention BasicTransformerBlocks, a final LayerNorm (eps 1e-6, the
    flax rule) -> the (B, T, D) cross-attention context;
  * `ClassEmbedder`: class ids -> a one-token (B, 1, D) context;
  * `HybridConditioner`: a concat conditioner and a cross-attention one ->
    the {c_concat, c_crossattn} pair of the UNet's hybrid mode;
  * `SpatialRescaler`: `n_stages` resizes by `multiplier` through
    jax.image's weight matrices (`jax.image.resize` antialiases when it
    shrinks; `nn.vit.jax_image_resize`), then an optional bias-free 1x1
    `channel_mapper`.  Torch shapes are not lazy, so it takes the input
    width `in_channels` where flax reads it from the first call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.runtime import resolve_device
from .blocks import Conv
from .transformer import BasicTransformerBlock, LayerNorm
from .unet import init_weights

__all__ = ["TextFeatureRefiner", "FrozenBERTEmbedder", "IdentityEncoder", "TransformerTextEncoder",
           "ClassEmbedder", "HybridConditioner", "SpatialRescaler"]


def _seeded_init(module: nn.Module, device, seed: int) -> None:
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    init_weights(module, generator)


class TextFeatureRefiner(nn.Module):
    """(B, T, D) features -> refined (B, T, D).  Fresh init as the flax
    module's (lecun-normal kernels, zero biases, unit LayerNorm scales),
    seeded with `seed`."""

    def __init__(self, embed_dim: int = 768, n_heads: int = 8, depth: int = 4, d_head: int = 64,
                 dropout: float = 0.2, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim, self.depth = embed_dim, depth
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(embed_dim, n_heads, d_head, dropout, device=device))
        _seeded_init(self, device, seed)

    def forward(self, feats: torch.Tensor, noise=None) -> torch.Tensor:
        """Dropout only with a training `noise` source."""
        h = feats
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, None, noise)
        return h + feats


class TransformerTextEncoder(nn.Module):
    """(B, T) token ids -> (B, T, embed_dim) context: `tok_emb` + `pos_emb`
    [:T], `depth` blocks with no context (attn2 is self-attention too), then
    the LayerNorm `norm`.  Dropout only with a training `noise` source."""

    def __init__(self, vocab_size: int = 30522, embed_dim: int = 768, depth: int = 6, n_heads: int = 8,
                 d_head: int = 64, max_len: int = 512, dropout: float = 0.0, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.depth, self.max_len = depth, max_len
        self.tok_emb = nn.Embedding(vocab_size, embed_dim, device=device)
        self.pos_emb = nn.Parameter(torch.zeros(max_len, embed_dim, device=device))
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(embed_dim, n_heads, d_head, dropout, device=device))
        self.norm = LayerNorm(embed_dim, device=device)
        _seeded_init(self, device, seed)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed + 1)
        with torch.no_grad():  # flax's normal(0.02) for the positions
            self.pos_emb.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor, noise=None) -> torch.Tensor:
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"TransformerTextEncoder: {t} tokens, max_len {self.max_len}")
        h = self.tok_emb(tokens.long()) + self.pos_emb[None, :t]
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, None, noise)
        return self.norm(h)


class ClassEmbedder(nn.Module):
    """(B,) class ids -> (B, 1, embed_dim), the `embedding` table's rows."""

    def __init__(self, n_classes: int, embed_dim: int = 512, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.embedding = nn.Embedding(n_classes, embed_dim, device=device)
        _seeded_init(self, device, seed)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.embedding(y.long())[:, None, :]


class HybridConditioner(nn.Module):
    """The two raw conditions through their own encoders, as the pair
    `SliceLDM.apply_model(cond=c_concat, context=c_crossattn)` takes."""

    def __init__(self, concat_conditioner, crossattn_conditioner):
        super().__init__()
        self.concat_conditioner = concat_conditioner
        self.crossattn_conditioner = crossattn_conditioner

    def forward(self, c_concat: torch.Tensor, c_crossattn: torch.Tensor) -> dict:
        return {"c_concat": self.concat_conditioner(c_concat),
                "c_crossattn": self.crossattn_conditioner(c_crossattn)}


class SpatialRescaler(nn.Module):
    """(B, H, W, C) -> `n_stages` resizes to (max(1, int(H * multiplier)),
    ...) with jax.image's `method` ('bilinear' or 'bicubic', antialiased
    when shrinking), then with `out_channels` the bias-free 1x1
    `channel_mapper` from `in_channels`."""

    def __init__(self, n_stages: int = 1, multiplier: float = 0.5, method: str = "bilinear",
                 out_channels: Optional[int] = None, in_channels: Optional[int] = None, device=None, seed: int = 0):
        super().__init__()
        from .vit import _METHODS

        if method not in _METHODS:
            raise ValueError(f"SpatialRescaler: method {method!r} not in {sorted(_METHODS)}")
        device = resolve_device(device)
        self.n_stages, self.multiplier, self.method = n_stages, multiplier, method
        self.channel_mapper = None
        if out_channels is not None:
            if in_channels is None:
                raise ValueError("SpatialRescaler: out_channels needs in_channels (torch shapes are not lazy)")
            self.channel_mapper = Conv(in_channels, out_channels, 1, 2, use_bias=False, device=device)
            _seeded_init(self, device, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .vit import jax_image_resize

        for _ in range(self.n_stages):
            b, h, w, c = x.shape
            x = jax_image_resize(x, (b, max(1, int(h * self.multiplier)), max(1, int(w * self.multiplier)), c),
                                 self.method)
        return x if self.channel_mapper is None else self.channel_mapper(x)


class IdentityEncoder:
    """The condition passed through as it is."""

    def __call__(self, x):
        return x

    def encode(self, x):
        return x


class FrozenBERTEmbedder:
    """Frozen BERT features of a local model directory (`transformers`):
    texts -> numpy (B, n_chunks * L, D) float32, the last hidden state.  A
    text longer than `max_length` tokens is encoded in `max_length` chunks
    whose features are concatenated; shorter texts are zero-padded to the
    longest.  Runs on CUDA unless `device` says otherwise."""

    def __init__(self, model_name_or_path: str, max_length: int = 512, device=None):
        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as e:
            raise ImportError("FrozenBERTEmbedder needs the `transformers` package") from e
        self.device = resolve_device(device)
        self.tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        self.model = AutoModel.from_pretrained(model_name_or_path).eval().to(self.device)
        for p in self.model.parameters():
            p.requires_grad = False
        self.max_length = max_length

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        feats = []
        with torch.no_grad():
            for text in texts:
                ids = self.tokenizer(text, return_tensors="pt", truncation=False)["input_ids"][0]
                chunks = [ids[i:i + self.max_length] for i in range(0, len(ids), self.max_length)] or [ids]
                outs = [self.model(ch[None].to(self.device)).last_hidden_state[0] for ch in chunks]
                feats.append(torch.cat(outs, dim=0).float().cpu().numpy())
        out = np.zeros((len(feats), max(f.shape[0] for f in feats), feats[0].shape[-1]), np.float32)
        for i, f in enumerate(feats):
            out[i, :f.shape[0]] = f
        return out
