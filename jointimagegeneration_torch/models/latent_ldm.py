"""Latent diffusion: the slice UNet inside a frozen first-stage latent space.

Counterpart of `jointimagegeneration_tpu/models/latent_ldm.py` for sampling
(the `_ae` route of `configs/sample_ct_ae.yml`): per z-slice the pixel-space
[previous slice | mask slice] pair is encoded by the cond-stage KL-VAE (its
mode, not rescaled), the chain runs on the 4-channel latent with the pixel
`SliceLDM`'s samplers, the latent is decoded by the first stage and min-max
normalised, and that slice conditions the next.  The AEs compute in fp32
(`models/autoencoder.py`); the latent leaves the chain in fp32, as x_T is an
fp32 normal.

Every draw comes from the one `NoiseSource`, in the JAX order: a cond encode
draws nothing; a slice draws its x_T first, or under warm start the q-noise
of the previous RAW latent.  Under guidance the unconditional branch is the
encoding of the zeroed pixel condition, computed once a slice, not the zero
latent (a cond encoder does not map zero images to zero latents).

A VQ first stage diffuses in the pre-quantization latent and decodes through
the codebook.  `scale_factor` multiplies the diffusion latent only (fixed, or
1/std of an encoded batch by `calibrate_scale_factor`).  Not ported yet:
`train_loss_inputs` (the latent training step).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..diffusion.ddim import DDIMParams
from ..diffusion.gaussian import GaussianDiffusion
from ..diffusion.noise import NoiseSource
from ..ops.tiling import tiled_apply
from .autoencoder import VQModel
from .slice_ldm import SliceLDM, _minmax_slice

__all__ = ["LatentSliceLDM"]


def _stage_encode(stage: nn.Module, x: torch.Tensor, noise: Optional[NoiseSource] = None) -> torch.Tensor:
    """KL: the posterior's mode, or a sample when a noise source is given;
    VQ: the pre-quant latent."""
    if isinstance(stage, VQModel):
        return stage.encode_prequant(x)
    posterior = stage.encode(x)
    return posterior.mode() if noise is None else posterior.sample(noise)


def _stage_decode(stage: nn.Module, z: torch.Tensor) -> torch.Tensor:
    """KL: plain; VQ: through the codebook."""
    return stage.decode_prequant(z) if isinstance(stage, VQModel) else stage.decode(z)


@dataclass(frozen=True)
class LatentSliceLDM:
    """A SliceLDM whose sample space is the first stage's latent.
    `cond_stage` encodes the pixel condition (the first stage does without
    one)."""

    inner: SliceLDM
    first_stage: nn.Module  # AutoencoderKL | VQModel
    cond_stage: Optional[nn.Module] = None
    scale_factor: float = 1.0

    @classmethod
    def create(cls, first_stage: nn.Module, cond_stage: Optional[nn.Module] = None, scale_factor: float = 1.0,
               **ldm_kwargs) -> "LatentSliceLDM":
        return cls(inner=SliceLDM.create(**ldm_kwargs), first_stage=first_stage, cond_stage=cond_stage,
                   scale_factor=scale_factor)

    @property
    def diffusion(self) -> GaussianDiffusion:
        return self.inner.diffusion

    @property
    def unet(self) -> nn.Module:
        return self.inner.unet

    # -- the frozen stages ---------------------------------------------------------

    @torch.no_grad()
    def encode(self, x: torch.Tensor, noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """x -> the scaled latent (KL: the mode unless a noise source is given)."""
        return self.scale_factor * _stage_encode(self.first_stage, x.float(), noise)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return _stage_decode(self.first_stage, z.float() / self.scale_factor)

    @torch.no_grad()
    def encode_cond(self, cond: torch.Tensor) -> torch.Tensor:
        """Pixel condition -> cond latent by the cond stage (or the first
        stage), its mode, not rescaled."""
        return _stage_encode(self.cond_stage or self.first_stage, cond.float())

    @torch.no_grad()
    def encode_tiled(self, x: torch.Tensor, patch: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
        """Patch-tiled encode with border-weighted stitching in latent space."""
        f = self.first_stage.downsample_factor
        z = tiled_apply(lambda tile: _stage_encode(self.first_stage, tile), x.float(), patch, stride,
                        out_channels=self.first_stage.embed_dim, out_scale=1.0 / f)
        return self.scale_factor * z

    @torch.no_grad()
    def decode_tiled(self, z: torch.Tensor, patch: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
        """Patch-tiled decode; patch and stride in latent pixels."""
        f = self.first_stage.downsample_factor
        return tiled_apply(lambda tile: _stage_decode(self.first_stage, tile), z.float() / self.scale_factor,
                           patch, stride, out_channels=self.first_stage.out_ch, out_scale=float(f))

    def make_quantize_fn(self):
        """With a VQ first stage, the ancestral samplers' `quantize_fn`: unscale,
        snap to the codebook, rescale.  None for a KL stage."""
        if not isinstance(self.first_stage, VQModel):
            return None

        def fn(x0: torch.Tensor) -> torch.Tensor:
            return self.scale_factor * self.first_stage.quantize(x0 / self.scale_factor)[0]

        return fn

    @torch.no_grad()
    def calibrate_scale_factor(self, batch_x: torch.Tensor) -> "LatentSliceLDM":
        """scale_by_std: a copy with scale_factor = 1 / std of the encoded batch."""
        z = _stage_encode(self.first_stage, batch_x.float())
        return replace(self, scale_factor=float(1.0 / torch.std(z, correction=0)))

    # -- sampling ------------------------------------------------------------------

    @torch.no_grad()
    def sample_slice(self, noise: NoiseSource, cond: torch.Tensor, ddim: DDIMParams, encode_cond: bool = True,
                     **kw):
        """One slice from a PIXEL condition (a latent one with
        `encode_cond=False`); `kw` go to `SliceLDM.sample_slice`.  With
        `return_intermediates` the latent pred_x0 rows come back beside the
        decoded sample."""
        cond_z = self.encode_cond(cond) if encode_cond else cond
        out = self.inner.sample_slice(noise, cond_z, ddim, **kw)
        if kw.get("return_intermediates"):
            z, inter = out
            return self.decode(z), inter
        return self.decode(out)

    def _volume_slice_step(self, noise: NoiseSource, prev: torch.Tensor, mask_slice: torch.Tensor,
                           ddim: DDIMParams, guidance_scale: float = 1.0, prev_raw: Optional[torch.Tensor] = None,
                           warm_index: Optional[int] = None, sampler: str = "ddim"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One z-step: cond encode, the latent chain, decode, min-max
        normalisation.  Returns (normalised pixel slice, raw latent).  With
        `warm_index=k` and `prev_raw`, the previous raw latent is q-noised to
        node k-1 and only the last k nodes run."""
        cond_pix = torch.cat([prev, mask_slice], dim=-1)
        cond_z = self.encode_cond(cond_pix)
        uncond_z = self.encode_cond(torch.zeros_like(cond_pix)) if guidance_scale != 1.0 else None
        x_T = start = None
        if warm_index is not None and prev_raw is not None:
            a = ddim.alphas[warm_index - 1]
            eps = noise.normal(prev_raw.shape).to(prev_raw.dtype)
            x_T = float(np.sqrt(a)) * prev_raw + float(np.sqrt(np.float32(1.0) - a)) * eps
            start = warm_index
        if sampler != "ddim":
            z = self.inner._sample_slice_multistep(noise, cond_z, ddim, sampler, guidance_scale=guidance_scale,
                                                   uncond_cond=uncond_z, x_T=x_T, start_index=start)
        else:
            z = self.inner.sample_slice(noise, cond_z, ddim, guidance_scale=guidance_scale, uncond_cond=uncond_z,
                                        x_T=x_T, start_index=start)
        return _minmax_slice(self.decode(z)), z

    @torch.no_grad()
    def stream_volume(self, noise: NoiseSource, mask_volume: torch.Tensor, ddim: DDIMParams,
                      init_slice: Optional[torch.Tensor] = None, guidance_scale: float = 1.0,
                      warm_start: Optional[float] = None, sampler: str = "ddim") -> Iterator[torch.Tensor]:
        """Yield the decoded (B, H, W, out_ch) slices of a (B, D, H, W, 1) pixel
        mask channel one at a time; the first is conditioned on `init_slice`
        (zeros by default) and runs the full chain, `warm_start` and `sampler`
        as in `SliceLDM.stream_volume`."""
        SliceLDM._check_sampler(sampler, None, ddim)
        warm = SliceLDM.warm_start_index(ddim, warm_start)
        b, d, h, w, _ = mask_volume.shape
        prev = (torch.zeros((b, h, w, self.first_stage.out_ch), device=mask_volume.device)
                if init_slice is None else init_slice)
        prev_raw = None
        for z in range(d):
            prev, prev_raw = self._volume_slice_step(
                noise, prev, mask_volume[:, z], ddim, guidance_scale=guidance_scale, prev_raw=prev_raw,
                warm_index=warm if z > 0 else None, sampler=sampler)
            yield prev

    def sample_volume(self, noise: NoiseSource, mask_volume: torch.Tensor, ddim: DDIMParams,
                      init_slice: Optional[torch.Tensor] = None, guidance_scale: float = 1.0,
                      warm_start: Optional[float] = None, sampler: str = "ddim") -> torch.Tensor:
        """All D slices of `stream_volume`, stacked: (B, D, H, W, out_ch)."""
        return torch.stack(list(self.stream_volume(noise, mask_volume, ddim, init_slice=init_slice,
                                                   guidance_scale=guidance_scale, warm_start=warm_start,
                                                   sampler=sampler)), dim=1)
