"""The feature / text condition-encoder registry.

Counterpart of `jointimagegeneration_tpu/models/cond_encoders.py`:
`build_feature_cond_encoder` builds the encoder a `feature_cond_encoder`
config section names ('none' -> None, 'selfattn' -> a `TextFeatureRefiner`
over precomputed BERT features, 'dino' -> a frozen `ViTExtractor`),
`inject_site_downsample` gives the spatial downsample factor of a UNet
encoder injection site, and `make_dense_feature_fn` turns the extractor into
the (B, H, W, C) images -> (B, th, tw, D) feature map that the UNet
concatenates at that site.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..nn.text import TextFeatureRefiner
from ..nn.vit import ViTExtractor, jax_image_resize

__all__ = ["build_feature_cond_encoder", "inject_site_downsample", "make_dense_feature_fn"]


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


def make_dense_feature_fn(extractor: ViTExtractor, spatial: Sequence[int], layer: int = 11,
                          facet: str = "key") -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, H, W, C) images -> the (B, th, tw, D) fp32 map of `layer`'s
    `facet`, resized to the injection-site grid `spatial` by
    `jax.image.resize`'s 'bilinear' (antialiased; `nn.vit.jax_image_resize`).
    An image that is not RGB enters as its channel mean tiled to 3 channels."""
    th, tw = spatial

    def fn(images: torch.Tensor) -> torch.Tensor:
        rgb = images if images.shape[-1] == 3 else images.float().mean(-1, keepdim=True).expand(
            *images.shape[:-1], 3)
        f = extractor.extract(rgb, layers=(layer,), facet=facet)[0]
        return jax_image_resize(f, (images.shape[0], th, tw, f.shape[-1]), "bilinear")

    return fn


def build_feature_cond_encoder(cfg: Optional[dict], device=None, seed: int = 0
                               ) -> Tuple[Optional[Union[TextFeatureRefiner, ViTExtractor]], bool]:
    """(encoder, trainable): (None, False) for 'none'; for 'selfattn' a fresh
    `TextFeatureRefiner` (embed_dim 768, n_heads 8, model_depth 4, d_head 64,
    dropout 0.2 unless the section says otherwise) on `device`, seeded with
    `seed`, trainable unless `train: false`; for 'dino' a frozen
    `ViTExtractor` (`model_type` vits8, `output_stride` 8, `weights_path` a
    local DINO checkpoint, else the init seeded with `seed`), never trained."""
    kind = (cfg or {}).get("type", "none")
    if kind in (None, "none"):
        return None, False
    if kind == "selfattn":
        enc = TextFeatureRefiner(embed_dim=cfg.get("embed_dim", 768), n_heads=cfg.get("n_heads", 8),
                                 depth=cfg.get("model_depth", 4), d_head=cfg.get("d_head", 64),
                                 dropout=cfg.get("dropout", 0.2), device=device, seed=seed)
        return enc, bool(cfg.get("train", True))
    if kind == "dino":
        return ViTExtractor(model_type=cfg.get("model_type", "vits8"), stride=cfg.get("output_stride", 8),
                            weights_path=cfg.get("weights_path"), device=device, seed=seed), False
    raise ValueError(f"unknown feature_cond_encoder type {kind!r}")
