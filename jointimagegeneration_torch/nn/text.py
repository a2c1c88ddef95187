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
  * `IdentityEncoder`: the passthrough.
The stage-2 conditioners (`TransformerTextEncoder`, `ClassEmbedder`,
`HybridConditioner`, `SpatialRescaler`) come with stage-2 conditioning.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.runtime import resolve_device
from .transformer import BasicTransformerBlock
from .unet import init_weights

__all__ = ["TextFeatureRefiner", "FrozenBERTEmbedder", "IdentityEncoder"]


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
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        init_weights(self, generator)

    def forward(self, feats: torch.Tensor, noise=None) -> torch.Tensor:
        """Dropout only with a training `noise` source."""
        h = feats
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, None, noise)
        return h + feats


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
