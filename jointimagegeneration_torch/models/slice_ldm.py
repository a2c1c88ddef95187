"""Stage 2: conditional CT slice generator with autoregressive volume assembly.

Counterpart of `jointimagegeneration_tpu/models/slice_ldm.py` on its plain
DDIM path: each slice runs a DDIM chain from pure noise with the concat
condition [previous generated slice | mask slice], is min-max normalised
(eps 1e-8 over H, W, C) and becomes the next slice's condition.  For
training, `create(learn_logvar=True)` adds the learned per-timestep
log-variance, an fp32 (T,) parameter that `named_parameters()` lists beside
the UNet's under the name `logvar` (the JAX params tree's sibling leaf).
Not ported here: warm start, the PLMS / DPM-Solver samplers, classifier-free
guidance, patch tiling and the `log_images` panels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..diffusion.ddim import DDIMParams, ddim_step
from ..diffusion.gaussian import GaussianDiffusion
from ..diffusion.noise import NoiseSource
from ..nn.unet import UNet

__all__ = ["SliceLDM"]


def _minmax_slice(s: torch.Tensor) -> torch.Tensor:
    """Per-slice min-max normalisation of (B, H, W, C) into [0, 1]."""
    lo = s.amin(dim=(1, 2, 3), keepdim=True)
    hi = s.amax(dim=(1, 2, 3), keepdim=True)
    return (s - lo) / torch.clamp_min(hi - lo, 1e-8)


@dataclass(frozen=True)
class SliceLDM:
    unet: UNet
    diffusion: GaussianDiffusion
    channels: int = 1  # generated image channels
    cond_channels: int = 2  # [previous slice, mask slice]
    logvar: Optional[torch.nn.Parameter] = None  # (T,) fp32, with learn_logvar

    @classmethod
    def create(
        cls,
        image_channels: int = 1,
        cond_channels: int = 2,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 0.0015,
        linear_end: float = 0.0195,
        model_channels: int = 128,
        channel_mult: Sequence[int] = (1, 2, 4, 4, 5),
        attention_resolutions: Sequence[int] = (32, 16, 8),
        num_res_blocks: int = 2,
        num_head_channels: int = 32,
        parameterization: str = "eps",
        learn_logvar: bool = False,
        logvar_init: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 1,
    ) -> "SliceLDM":
        unet = UNet(
            in_channels=image_channels + cond_channels,
            model_channels=model_channels,
            out_channels=image_channels,
            num_res_blocks=num_res_blocks,
            attention_resolutions=attention_resolutions,
            channel_mult=channel_mult,
            dims=2,
            num_head_channels=num_head_channels,
            softmax_output=False,
            dtype=dtype,
            device=device,
            seed=seed,
        )
        diffusion = GaussianDiffusion.create(beta_schedule, timesteps, linear_start=linear_start,
                                             linear_end=linear_end, parameterization=parameterization)
        logvar = None
        if learn_logvar:
            device = next(unet.parameters()).device
            logvar = torch.nn.Parameter(torch.full((timesteps,), float(logvar_init), device=device))
        return cls(unet=unet, diffusion=diffusion, channels=image_channels,
                   cond_channels=cond_channels, logvar=logvar)

    def named_parameters(self) -> List[Tuple[str, torch.nn.Parameter]]:
        """The trainable parameters by name: the UNet's, then `logvar`."""
        named = list(self.unet.named_parameters())
        return named if self.logvar is None else named + [("logvar", self.logvar)]

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """eps prediction with 'concat' conditioning."""
        return self.unet(x, t.float(), cond=cond)

    @torch.no_grad()
    def sample_slice(self, noise: NoiseSource, cond: torch.Tensor, ddim: DDIMParams) -> torch.Tensor:
        """The DDIM chain for one (B, H, W, C) slice from pure noise."""
        b, h, w, _ = cond.shape
        x = noise.normal((b, h, w, self.channels))
        for index in range(ddim.num_steps - 1, -1, -1):
            t_b = torch.full((b,), int(ddim.timesteps[index]), dtype=torch.int64, device=x.device)
            e_t = self.apply_model(x, t_b, cond=cond)
            x, _ = ddim_step(ddim, noise, x, e_t.to(x.dtype), index)
        return x

    def _volume_slice_step(self, noise: NoiseSource, prev: torch.Tensor, mask_slice: torch.Tensor,
                           ddim: DDIMParams) -> Tuple[torch.Tensor, torch.Tensor]:
        """One autoregressive z-step: [prev | mask] concat-conditioned DDIM
        chain, then min-max normalisation.  Returns (normalised, raw)."""
        cond = torch.cat([prev, mask_slice], dim=-1)
        s = self.sample_slice(noise, cond, ddim)
        return _minmax_slice(s), s

    @torch.no_grad()
    def sample_volume(self, noise: NoiseSource, mask_volume: torch.Tensor, ddim: DDIMParams,
                      init_slice: Optional[torch.Tensor] = None, tile=None,
                      guidance_scale: float = 1.0, warm_start: Optional[float] = None,
                      sampler: str = "ddim") -> torch.Tensor:
        """All D slices of a (B, D, H, W, 1) mask channel, autoregressively;
        returns (B, D, H, W, C).  The first slice is conditioned on
        `init_slice` (zeros by default)."""
        if sampler != "ddim":
            raise NotImplementedError(f"sampler={sampler!r} is not ported; only 'ddim'")
        if warm_start is not None:
            raise NotImplementedError("warm_start is not ported")
        if guidance_scale != 1.0:
            raise NotImplementedError("classifier-free guidance (guidance_scale != 1) is not ported")
        if tile is not None:
            raise NotImplementedError("tile is not ported")
        b, d, h, w, _ = mask_volume.shape
        prev = (torch.zeros((b, h, w, self.channels), device=mask_volume.device)
                if init_slice is None else init_slice)
        slices = []
        for z in range(d):
            prev, _ = self._volume_slice_step(noise, prev, mask_volume[:, z], ddim)
            slices.append(prev)
        return torch.stack(slices, dim=1)
