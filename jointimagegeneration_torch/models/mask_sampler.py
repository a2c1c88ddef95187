"""Stage 1: the categorical-diffusion volumetric mask sampler.

Counterpart of `jointimagegeneration_tpu/models/mask_sampler.py`: a 3D UNet
predicts x0 class probabilities and the sampler walks the categorical
posterior from t = T down to t = 1 over a K-step subset round(linspace(T, 1,
K)), carrying integer labels between steps and decoding at t = 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.categorical import CategoricalDiffusion, max_prob_one_hot, sample_one_hot
from ..diffusion.noise import NoiseSource
from ..nn.unet import UNet

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
    ) -> "MaskSampler":
        """UNet input = one-hot classes + `cond_channels` condition channels."""
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
        )
        device = next(unet.parameters()).device
        diffusion = CategoricalDiffusion.create(schedule, time_steps, num_classes, device=device)
        return cls(unet=unet, diffusion=diffusion, num_classes=num_classes,
                   step_T_sample=step_T_sample)

    @torch.no_grad()
    def denoise_step(self, noise: NoiseSource, xt: torch.Tensor, t: torch.Tensor,
                     cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """UNet x0-probs -> categorical posterior -> the next one-hot x_{t-1};
        at t <= 1 the decode rule applies instead of the draw."""
        x0pred = self.unet(xt, t.float(), cond=cond)
        probs = self.diffusion.theta_post_prob(xt, x0pred, t).clamp_min(1e-12)
        sampled = sample_one_hot(noise, probs)
        decoded = sampled if self.step_T_sample == "confidence" else max_prob_one_hot(probs)
        is_last = (t <= 1).reshape((-1,) + (1,) * (xt.ndim - 1))
        return torch.where(is_last, decoded, sampled)

    @torch.no_grad()
    def sample(self, noise: NoiseSource, shape: Sequence[int], cond: Optional[torch.Tensor] = None,
               num_steps: Optional[int] = None) -> torch.Tensor:
        """A (B, D, H, W, C) one-hot mask volume, decoded at t = 1, from a
        uniform categorical draw."""
        b = shape[0]
        device = self.diffusion.alphas.device
        uniform = torch.full((*shape, self.num_classes), 1.0 / self.num_classes, device=device)
        lab = torch.argmax(sample_one_hot(noise, uniform), dim=-1)
        for t in sampling_t_values(self.diffusion.time_steps, num_steps):
            xt = F.one_hot(lab, self.num_classes).float()
            t_b = torch.full((b,), int(t), dtype=torch.int64, device=device)
            lab = torch.argmax(self.denoise_step(noise, xt, t_b, cond=cond), dim=-1)
        return F.one_hot(lab, self.num_classes).float()

    def sample_labels(self, noise: NoiseSource, shape: Sequence[int], **kw) -> torch.Tensor:
        """Integer label volume (B, D, H, W): the stage-1 -> stage-2 contract."""
        return torch.argmax(self.sample(noise, shape, **kw), dim=-1)
