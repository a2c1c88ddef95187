"""End-to-end mask -> CT pipeline on the pixel path.

Counterpart of `jointimagegeneration_tpu/pipeline/two_stage.py`: stage-1
labels -> nearest-neighbour upsample to the CT grid -> the mask channel
labels / (C - 1) -> the autoregressive stage-2 volume.  A text `context`
goes to the mask sampler (which refines it when it has a refiner); stage 2
takes none (the JAX pipeline hands it the same context, which its UNet
without `context_dim` ignores).  The stage-2
options `guidance_scale`, `warm_start` and `sampler` passed through to
`SliceLDM.sample_volume`.  Stage 2 may be a `LatentSliceLDM` (the `_ae`
route): its volume encodes each [previous slice | mask slice] pair, runs the
chain in latent space and decodes, so a chunk's `init_slice` is a pixel slice
of `first_stage.out_ch` channels; without a first stage it raises.  The
chunked programs split the z loop into chunks,
each seeded with the previous chunk's last slice, which keeps the
autoregressive semantics exactly, except that under `warm_start` each chunk's
first slice runs the full chain (a chunk carries only `init_slice`, as the JAX
chunked programs do).  With one chunk over all the slices (`cli.sample`'s
default), the chunked programs give the JAX CLI's unchunked
`TwoStagePipeline`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..diffusion.ddim import DDIMParams
from ..diffusion.noise import NoiseSource
from ..models.latent_ldm import LatentSliceLDM
from ..models.mask_sampler import MaskSampler
from ..models.slice_ldm import SliceLDM

__all__ = ["TwoStagePipeline", "upsample_labels", "normalize_mask_channel",
           "make_chunked_two_stage_programs"]


def upsample_labels(labels: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """Nearest-neighbour resize of an integer label volume (B, D, H, W).

    'nearest-exact' (source index floor((i + 0.5) * in / out)) is what
    jax.image.resize(..., 'nearest') computes; torch's 'nearest' differs at
    non-integer ratios."""
    up = F.interpolate(labels[:, None].float(), size=tuple(target_shape), mode="nearest-exact")
    return up[:, 0].to(labels.dtype)


def normalize_mask_channel(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels -> the [0, 1] stage-2 mask condition channel (..., 1)."""
    return labels.float()[..., None] / max(num_classes - 1, 1)


def _check_stage2(slice_ldm) -> None:
    if isinstance(slice_ldm, LatentSliceLDM) and slice_ldm.first_stage is None:
        raise ValueError("latent two-stage pipeline needs the first-stage AE (its weights)")


@dataclass(frozen=True)
class TwoStagePipeline:
    mask_sampler: MaskSampler
    slice_ldm: Union[SliceLDM, LatentSliceLDM]

    def __post_init__(self):
        _check_stage2(self.slice_ldm)

    def __call__(self, noise: NoiseSource, *, mask_shape: Tuple[int, int, int, int],
                 volume_shape: Tuple[int, int, int], ddim: DDIMParams,
                 mask_steps: Optional[int] = None, cond: Optional[torch.Tensor] = None,
                 context: Optional[torch.Tensor] = None, guidance_scale: float = 1.0,
                 warm_start: Optional[float] = None, sampler: str = "ddim") -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (ct volume (B, D', H', W', C), labels (B, D', H', W'))."""
        labels = self.mask_sampler.sample_labels(noise, mask_shape, cond=cond, num_steps=mask_steps,
                                                 context=context)
        labels_up = upsample_labels(labels, volume_shape)
        mask_channel = normalize_mask_channel(labels_up, self.mask_sampler.num_classes)
        ct = self.slice_ldm.sample_volume(noise, mask_channel, ddim, guidance_scale=guidance_scale,
                                          warm_start=warm_start, sampler=sampler)
        return ct, labels_up


def make_chunked_two_stage_programs(mask_sampler: MaskSampler, slice_ldm: Union[SliceLDM, LatentSliceLDM], *,
                                    mask_shape: Tuple[int, int, int, int],
                                    volume_shape: Tuple[int, int, int],
                                    ddim: DDIMParams, chunk: int,
                                    mask_steps: Optional[int] = None,
                                    cond: Optional[torch.Tensor] = None,
                                    context: Optional[torch.Tensor] = None, **sample_kw):
    """The two-stage pipeline as two callables:

      mask_program(noise) -> (labels (B, D', H', W'), mask channel (B, D', H', W', 1))
      chunk_program(noise, mask_chunk, init_slice) -> (vol (B, chunk, H', W', C), last slice)

    Driving chunk_program over consecutive `chunk`-slice windows of the mask
    channel, each with the previous call's last slice as `init_slice`, gives
    the same volume as one sample_volume call (under `warm_start`, up to each
    chunk's first slice, which runs the full chain).  `sample_kw`
    (`guidance_scale`, `warm_start`, `sampler`) go to sample_volume."""
    _check_stage2(slice_ldm)
    d = volume_shape[0]
    if d % chunk != 0:
        raise ValueError(f"volume depth {d} must divide by chunk {chunk}")

    def mask_program(noise: NoiseSource):
        labels = mask_sampler.sample_labels(noise, mask_shape, cond=cond, num_steps=mask_steps, context=context)
        up = upsample_labels(labels, volume_shape)
        return up, normalize_mask_channel(up, mask_sampler.num_classes)

    def chunk_program(noise: NoiseSource, mask_chunk: torch.Tensor, init_slice: Optional[torch.Tensor]):
        if mask_chunk.shape[1] != chunk:
            raise ValueError(f"mask chunk has {mask_chunk.shape[1]} slices, expected {chunk}")
        vol = slice_ldm.sample_volume(noise, mask_chunk, ddim, init_slice=init_slice, **sample_kw)
        return vol, vol[:, -1]

    return mask_program, chunk_program
