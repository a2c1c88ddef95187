"""Stage 1: the categorical-diffusion volumetric mask sampler.

Counterpart of `jointimagegeneration_tpu/models/mask_sampler.py`: a 3D UNet
predicts x0 class probabilities and the sampler walks the categorical
posterior from t = T down to t = 1 over a K-step subset round(linspace(T, 1,
K)), carrying integer labels between steps and decoding at t = 1.

Text guidance: with `context_dim` the UNet attends over a (B, T, context_dim)
context at every attention site, and with `text_refiner` a trainable
`TextFeatureRefiner` refines the raw features first (`refine_context`); its
parameters train and average with the UNet's (`named_parameters`, names
prefixed `refiner.`).  The JAX sampler refines inside every step; nothing in
the refinement is random at sampling, so `sample` refines once per call, which
gives the same context.  `guidance_fn(probs)` subtracts a gradient from the
posterior before the 1e-12 clamp (label-reference guidance).

Dense feature conditioning (the 'dino' encoder): `feature_cond_channels`
({site: F}, JAX `init_params(feature_cond_shapes=...)`) widens the UNet at
those encoder sites, and `feature_cond` ({site: (B, *spatial_at_site, F)})
goes to every UNet call of `denoise_step`, `sample` and `sample_labels`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.categorical import CategoricalDiffusion, max_prob_one_hot, sample_one_hot
from ..diffusion.noise import NoiseSource
from ..nn.text import TextFeatureRefiner
from ..nn.unet import UNet
from .cond_encoders import build_feature_cond_encoder

__all__ = ["MaskSampler", "sampling_t_values"]


def sampling_t_values(time_steps: int, num_steps: Optional[int] = None) -> np.ndarray:
    """Descending t values in [1, T]; a K-step subset via rounded linspace."""
    if num_steps is None or num_steps == time_steps:
        return np.arange(time_steps, 0, -1, dtype=np.int32)
    if not 0 < num_steps <= time_steps:
        raise ValueError(f"num_steps must be in [1, {time_steps}], got {num_steps}")
    return np.round(np.linspace(time_steps, 1, num_steps)).astype(np.int32)


@dataclass(frozen=True)
class MaskSampler:
    unet: UNet
    diffusion: CategoricalDiffusion
    num_classes: int
    step_T_sample: str = "majority"  # 'majority' (argmax) | 'confidence' (sample)
    refiner: Optional[TextFeatureRefiner] = None

    @classmethod
    def create(
        cls,
        num_classes: int = 12,
        cond_channels: int = 1,
        time_steps: int = 1000,
        schedule: str = "cosine",
        model_channels: int = 64,
        channel_mult: Sequence[int] = (1, 2, 2, 4, 5),
        attention_resolutions: Sequence[int] = (32, 16, 8),
        num_res_blocks: int = 2,
        num_head_channels: int = 32,
        dims: int = 3,
        dtype: torch.dtype = torch.float32,
        step_T_sample: str = "majority",
        device=None,
        seed: int = 0,
        use_fused_resblock=False,
        use_pallas_conv: bool = False,
        context_dim: Optional[int] = None,
        text_refiner: Optional[dict] = None,
        feature_cond_channels: Optional[Dict[int, int]] = None,
        remat: bool = False,
        remat_levels: Optional[Sequence[int]] = None,
        remat_policy: Optional[str] = None,
        spatial_axis: Optional[str] = None,
        mesh=None,
    ) -> "MaskSampler":
        """UNet input = one-hot classes + `cond_channels` condition channels.
        `use_fused_resblock` / `use_pallas_conv` pick the UNet's opt-in conv
        kernel paths (see `nn.unet.UNet`).  `context_dim` makes the attention
        sites cross-attend over a text context; `text_refiner` (the
        `feature_cond_encoder` dict: embed_dim, n_heads, model_depth, d_head,
        dropout) adds the trainable refiner, seeded with `seed` + 1.
        `feature_cond_channels` ({site: F}) widens the UNet for dense
        features at those encoder sites (`nn.unet.UNet`).  `remat`,
        `remat_levels` and `remat_policy` rematerialise the UNet's ResBlocks
        under autograd (`nn.unet.UNet`).  `mesh` and `spatial_axis` place the
        UNet's calls on a device mesh (`nn.unet.UNet`); the sampler's own
        arithmetic and its draws stay on the whole tensors, on `device`."""
        if step_T_sample not in ("majority", "confidence"):
            raise ValueError(f"step_T_sample must be 'majority' or 'confidence', got {step_T_sample!r}")
        unet = UNet(
            in_channels=num_classes + cond_channels,
            model_channels=model_channels,
            out_channels=num_classes,
            num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
            channel_mult=channel_mult,
            dims=dims,
            num_head_channels=num_head_channels,
            softmax_output=True,
            dtype=dtype,
            device=device,
            seed=seed,
            use_fused_resblock=use_fused_resblock,
            use_pallas_conv=use_pallas_conv,
            context_dim=context_dim,
            feature_cond_channels=feature_cond_channels,
            remat=remat,
            remat_levels=remat_levels,
            remat_policy=remat_policy,
            spatial_axis=spatial_axis,
            mesh=mesh,
        )
        device = next(unet.parameters()).device
        diffusion = CategoricalDiffusion.create(schedule, time_steps, num_classes, device=device)
        refiner = None
        if text_refiner is not None:
            section = {**text_refiner, "type": "selfattn",
                       "embed_dim": text_refiner.get("embed_dim", context_dim or 768)}
            refiner, _ = build_feature_cond_encoder(section, device, seed + 1)
        return cls(unet=unet, diffusion=diffusion, num_classes=num_classes,
                   step_T_sample=step_T_sample, refiner=refiner)

    def named_parameters(self) -> List[Tuple[str, torch.nn.Parameter]]:
        """The trainable parameters by name: the UNet's, then the refiner's
        as `refiner.<name>`."""
        named = list(self.unet.named_parameters())
        if self.refiner is not None:
            named += [(f"refiner.{n}", p) for n, p in self.refiner.named_parameters()]
        return named

    def refine_context(self, context: Optional[torch.Tensor], noise=None) -> Optional[torch.Tensor]:
        """The refiner's output over the raw `context` (as it is without a
        refiner or a context); dropout only with a training `noise` source."""
        if self.refiner is None or context is None:
            return context
        return self.refiner(context, noise)

    @torch.no_grad()
    def denoise_step(self, noise: NoiseSource, xt: torch.Tensor, t: torch.Tensor,
                     cond: Optional[torch.Tensor] = None, context: Optional[torch.Tensor] = None,
                     guidance_fn: Optional[Callable] = None, feature_cond: Optional[dict] = None) -> torch.Tensor:
        """UNet x0-probs -> categorical posterior -> the next one-hot x_{t-1};
        at t <= 1 the decode rule applies instead of the draw.  `context` is
        the raw text context, refined here."""
        return self._step(noise, xt, t, cond, self.refine_context(context), guidance_fn, feature_cond)

    def _step(self, noise, xt, t, cond, context, guidance_fn, feature_cond=None) -> torch.Tensor:
        """`denoise_step` on an already refined context."""
        x0pred = self.unet(xt, t.float(), cond=cond, context=context, feature_cond=feature_cond)
        probs = self.diffusion.theta_post_prob(xt, x0pred, t)
        if guidance_fn is not None:
            probs = probs - guidance_fn(probs)
        probs = probs.clamp_min(1e-12)
        sampled = sample_one_hot(noise, probs)
        decoded = sampled if self.step_T_sample == "confidence" else max_prob_one_hot(probs)
        is_last = (t <= 1).reshape((-1,) + (1,) * (xt.ndim - 1))
        return torch.where(is_last, decoded, sampled)

    @torch.no_grad()
    def sample(self, noise: NoiseSource, shape: Sequence[int], cond: Optional[torch.Tensor] = None,
               num_steps: Optional[int] = None, context: Optional[torch.Tensor] = None,
               guidance_fn: Optional[Callable] = None, feature_cond: Optional[dict] = None) -> torch.Tensor:
        """A (B, D, H, W, C) one-hot mask volume, decoded at t = 1, from a
        uniform categorical draw; the raw `context` is refined once."""
        b = shape[0]
        context = self.refine_context(context)
        device = self.diffusion.alphas.device
        uniform = torch.full((*shape, self.num_classes), 1.0 / self.num_classes, device=device)
        lab = torch.argmax(sample_one_hot(noise, uniform), dim=-1)
        for t in sampling_t_values(self.diffusion.time_steps, num_steps):
            xt = F.one_hot(lab, self.num_classes).float()
            t_b = torch.full((b,), int(t), dtype=torch.int64, device=device)
            lab = torch.argmax(self._step(noise, xt, t_b, cond, context, guidance_fn, feature_cond), dim=-1)
        return F.one_hot(lab, self.num_classes).float()

    def sample_labels(self, noise: NoiseSource, shape: Sequence[int], **kw) -> torch.Tensor:
        """Integer label volume (B, D, H, W): the stage-1 -> stage-2 contract."""
        return torch.argmax(self.sample(noise, shape, **kw), dim=-1)
