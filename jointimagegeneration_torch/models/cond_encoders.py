"""The feature / text condition-encoder registry.

Counterpart of `jointimagegeneration_tpu/models/cond_encoders.py`:
`build_feature_cond_encoder` builds the encoder a `feature_cond_encoder`
config section names ('none' -> None, 'selfattn' -> a `TextFeatureRefiner`
over precomputed BERT features), and `inject_site_downsample` gives the
spatial downsample factor of a UNet encoder injection site.  The 'dino'
encoder (a frozen ViT's dense features) comes with the rest of conditioning
(ROADMAP section 1, item 7).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..nn.text import TextFeatureRefiner

__all__ = ["build_feature_cond_encoder", "inject_site_downsample"]


def inject_site_downsample(channel_mult: Sequence[int], num_res_blocks: int, idx: int) -> int:
    """Spatial downsample factor of the UNet encoder at injection site `idx`:
    idx 0 is the stem, each ResBlock advances by one, each down-transition
    advances by one (still at its level's factor) and doubles it."""
    block_idx, ds = 1, 1
    if idx == 0:
        return 1
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            if block_idx == idx:
                return ds
            block_idx += 1
        if level != len(channel_mult) - 1:
            if block_idx == idx:
                return ds
            block_idx += 1
            ds *= 2
    raise ValueError(f"inject_idx {idx} beyond the encoder ({block_idx - 1} sites)")


def build_feature_cond_encoder(cfg: Optional[dict], device=None, seed: int = 0
                               ) -> Tuple[Optional[TextFeatureRefiner], bool]:
    """(encoder, trainable): (None, False) for 'none'; for 'selfattn' a fresh
    `TextFeatureRefiner` (embed_dim 768, n_heads 8, model_depth 4, d_head 64,
    dropout 0.2 unless the section says otherwise) on `device`, seeded with
    `seed`, trainable unless `train: false`."""
    kind = (cfg or {}).get("type", "none")
    if kind in (None, "none"):
        return None, False
    if kind == "selfattn":
        enc = TextFeatureRefiner(embed_dim=cfg.get("embed_dim", 768), n_heads=cfg.get("n_heads", 8),
                                 depth=cfg.get("model_depth", 4), d_head=cfg.get("d_head", 64),
                                 dropout=cfg.get("dropout", 0.2), device=device, seed=seed)
        return enc, bool(cfg.get("train", True))
    if kind == "dino":
        raise NotImplementedError("feature_cond_encoder type 'dino' (a frozen ViT's dense features) is not "
                                  "ported yet: ROADMAP section 1, item 7")
    raise ValueError(f"unknown feature_cond_encoder type {kind!r}")
