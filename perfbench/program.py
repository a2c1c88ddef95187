"""The program's models as its CLIs build them from a configuration file of
`perfbench/configs/`, with the benchmark's seeded weights loaded."""

from __future__ import annotations

import torch

from .weights import make_weights

__all__ = ["slice_ldm", "mask_sampler", "text_encoder", "load_seeded"]


def slice_ldm(cfg: dict, device):
    """Stage 2's `SliceLDM`, as `cli/sample.build_slice_ldm` builds it."""
    from jointimagegeneration_torch.models.slice_ldm import SliceLDM

    return SliceLDM.create(
        image_channels=cfg["image_channels"], cond_channels=cfg["cond_channels"], timesteps=cfg["timesteps"],
        beta_schedule=cfg["beta_schedule"], linear_start=cfg["linear_start"], linear_end=cfg["linear_end"],
        model_channels=cfg["model_channels"], channel_mult=tuple(cfg["channel_mult"]),
        attention_resolutions=tuple(cfg["attention_resolutions"]), num_res_blocks=cfg["num_res_blocks"],
        num_head_channels=cfg["num_head_channels"], dtype=getattr(torch, cfg["dtype"]), device=device)


def text_encoder(cfg: dict):
    """The configuration's `feature_cond_encoder` where it is the text
    refiner (type selfattn), else None."""
    enc = cfg.get("feature_cond_encoder") or {}
    return enc if enc.get("type") == "selfattn" else None


def mask_sampler(cfg: dict, device):
    """Stage 1's `MaskSampler`, as `cli/sample.build_mask_sampler` builds it:
    with a selfattn `feature_cond_encoder`, the UNet cross-attends over a
    context of its `embed_dim` through the trainable text refiner."""
    from jointimagegeneration_torch.models.mask_sampler import MaskSampler

    enc = text_encoder(cfg)
    return MaskSampler.create(
        num_classes=cfg["num_classes"], cond_channels=cfg["cond_channels"], time_steps=cfg["time_steps"],
        schedule=cfg["beta_schedule"], model_channels=cfg["model_channels"], channel_mult=tuple(cfg["channel_mult"]),
        attention_resolutions=tuple(cfg["attention_resolutions"]), num_res_blocks=cfg["num_res_blocks"],
        num_head_channels=cfg["num_head_channels"], dtype=getattr(torch, cfg["dtype"]),
        step_T_sample=cfg["step_T_sample"], device=device, context_dim=enc and enc["embed_dim"],
        text_refiner=enc)


def load_seeded(module: torch.nn.Module, seed: int, device) -> dict:
    """Load the weights made from `seed` into `module` (a UNet, the text
    refiner); returns {name: shape}, from which the reference makes the same
    weights again."""
    shapes = {n: t.shape for n, t in module.named_parameters()}
    module.load_state_dict(make_weights(shapes, seed, device))
    return shapes
