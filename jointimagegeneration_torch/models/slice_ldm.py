"""Stage 2: conditional CT slice generator with autoregressive volume assembly.

Counterpart of `jointimagegeneration_tpu/models/slice_ldm.py` in pixel space,
with Python loops where the JAX package scans.  Each slice runs a chain (DDIM,
or the multistep PLMS / DPM-Solver++(2M) solvers) with the concat condition
[previous generated slice | mask slice], is min-max normalised (eps 1e-8 over
H, W, C) and becomes the next slice's condition.  The routes: classifier-free
guidance (two sequential batch-B calls, combined in the output's dtype),
inpainting, patch tiling (DDIM only), warm start (SDEdit-style short chains
after the first slice), the full-T ancestral loops, streaming over z and the
`log_images` panels.  Every draw comes from one `NoiseSource`, in the JAX
order: a slice's x_T first (or, under warm start, the q-noise of the previous
raw slice), then per step the inpainting noise before the model call and the
DDIM noise (eta > 0 only) after it.

For training, `create(learn_logvar=True)` adds the learned per-timestep
log-variance, an fp32 (T,) parameter that `named_parameters()` lists beside
the UNet's under the name `logvar` (the JAX params tree's sibling leaf).
Not ported: cross-attention `context`, class ids `y`, `uncond_context` and
`guidance_fn` (the UNet raises on them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diffusion.ddim import DDIMParams, ddim_step
from ..diffusion.dpm_solver import dpm_solver_sample_loop
from ..diffusion.gaussian import GaussianDiffusion
from ..diffusion.noise import NoiseSource
from ..diffusion.plms import plms_sample_loop
from ..nn.unet import UNet
from ..ops.tiling import tiled_apply

__all__ = ["SliceLDM"]

Tile = Tuple[Tuple[int, int], Tuple[int, int]]  # ((patch h, w), (stride h, w))
_LOOPS = {"plms": plms_sample_loop, "dpm": dpm_solver_sample_loop}


def _minmax_slice(s: torch.Tensor) -> torch.Tensor:
    """Per-slice min-max normalisation of (B, H, W, C) into [0, 1]."""
    lo = s.amin(dim=(1, 2, 3), keepdim=True)
    hi = s.amax(dim=(1, 2, 3), keepdim=True)
    return (s - lo) / torch.clamp_min(hi - lo, 1e-8)


def _guided(out: torch.Tensor, out_u: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """out_u + s * (out - out_u) in the output's dtype, the scale rounded to
    that dtype through fp32 as the JAX package rounds it."""
    gs = float(torch.tensor(guidance_scale, dtype=torch.float32).to(out.dtype))
    return out_u + gs * (out - out_u)


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
        """The model output with 'concat' conditioning."""
        return self.unet(x, t.float(), cond=cond)

    def _to_eps(self, out: torch.Tensor, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Model output -> eps for the subset samplers, which all step in eps
        space.  An x0-parameterised output inverts q_sample:
        eps = (x_t - sqrt(abar_t) x0) / sqrt(1 - abar_t); an eps output is
        returned as it is.  `t` is the (B,) DDPM timestep."""
        if self.diffusion.parameterization == "eps":
            return out
        a = self.diffusion.buffer("alphas_cumprod", x.device)[t.long()].to(x.dtype)
        a = a.reshape(a.shape + (1,) * (x.ndim - 1))
        return (x - torch.sqrt(a) * out.to(x.dtype)) * torch.rsqrt(1.0 - a)

    @staticmethod
    def _check_sampler(sampler: str, tile: Optional[Tile], ddim: Optional[DDIMParams] = None) -> None:
        if sampler not in ("ddim", "plms", "dpm"):
            raise ValueError(f"unknown sampler {sampler!r}; expected 'ddim', 'plms' or 'dpm'")
        if sampler != "ddim" and tile is not None:
            raise ValueError(f"sampler={sampler!r} does not support tile (a DDIM-chain feature); "
                             "drop it or use sampler='ddim'")
        if sampler != "ddim" and ddim is not None and np.any(np.asarray(ddim.sigmas) != 0.0):
            # the multistep ODE updates have no stochastic sigma term
            raise ValueError(f"sampler={sampler!r} requires ddim_eta=0 (deterministic ODE solver); "
                             "this DDIMParams was built with nonzero eta")

    @staticmethod
    def warm_start_index(ddim: DDIMParams, warm_start: Optional[float]) -> Optional[int]:
        """The number of nodes a warm-started slice runs: round(f * S) (Python's
        round), clamped to [1, S]; None without warm start."""
        if warm_start is None:
            return None
        f = float(warm_start)
        if not 0.0 < f <= 1.0:
            raise ValueError(f"warm_start must be in (0, 1], got {warm_start}")
        return max(1, min(ddim.num_steps, int(round(f * ddim.num_steps))))

    # -- one slice ---------------------------------------------------------------

    def _model_fn(self, tile: Optional[Tile]) -> Callable:
        """(x, t, cond) -> model output; with `tile`, the [x | cond] windows
        move together through `tiled_apply` (the output then in x's dtype)."""
        if tile is None:
            return self.apply_model

        def tiled(x, t, cond):
            def fn(window):
                return self.apply_model(window[..., :self.channels], t, cond=window[..., self.channels:])

            return tiled_apply(fn, torch.cat([x, cond.to(x.dtype)], dim=-1), tile[0], tile[1],
                               out_channels=self.channels)

        return tiled

    @torch.no_grad()
    def sample_slice(self, noise: NoiseSource, cond: torch.Tensor, ddim: DDIMParams, *,
                     x_T: Optional[torch.Tensor] = None, temperature: float = 1.0,
                     guidance_scale: float = 1.0, inpaint_mask: Optional[torch.Tensor] = None,
                     inpaint_x0: Optional[torch.Tensor] = None, return_intermediates: bool = False,
                     tile: Optional[Tile] = None, uncond_cond: Optional[torch.Tensor] = None,
                     start_index: Optional[int] = None):
        """The DDIM chain for one (B, H, W, C) slice.

        `guidance_scale` != 1 runs classifier-free guidance: a second call with
        a zeroed `cond` (or `uncond_cond`), combined before the eps
        conversion; exactly 1.0 makes one call a step.  `inpaint_mask` (1 =
        keep) and `inpaint_x0` re-noise the kept region to each step's level
        before the model call.  `tile=((ph, pw), (sh, sw))` runs the UNet
        patch-tiled.  `start_index=k` runs only the last k steps from an x_T
        already at step k-1's noise level.  With `return_intermediates`,
        returns (x, pred_x0 trajectory (S, B, H, W, C))."""
        b, h, w, _ = cond.shape
        n_run = ddim.num_steps if start_index is None else int(start_index)
        if not 1 <= n_run <= ddim.num_steps:
            raise ValueError(f"start_index must be in [1, {ddim.num_steps}], got {start_index}")
        x = noise.normal((b, h, w, self.channels)) if x_T is None else x_T
        model = self._model_fn(tile)
        inpaint = inpaint_mask is not None and inpaint_x0 is not None
        inter = []
        for index in range(n_run - 1, -1, -1):
            t_b = torch.full((b,), int(ddim.timesteps[index]), dtype=torch.int64, device=x.device)
            if inpaint:
                x_orig = self.diffusion.q_sample(inpaint_x0, t_b, noise.normal(x.shape).to(x.dtype))
                x = x_orig * inpaint_mask + (1.0 - inpaint_mask) * x
            out = model(x, t_b, cond)
            if guidance_scale != 1.0:
                null = torch.zeros_like(cond) if uncond_cond is None else uncond_cond
                out = _guided(out, model(x, t_b, null), guidance_scale)
            x, pred_x0 = ddim_step(ddim, noise, x, self._to_eps(out, x, t_b).to(x.dtype), index, temperature)
            if return_intermediates:
                inter.append(pred_x0)
        return (x, torch.stack(inter)) if return_intermediates else x

    @torch.no_grad()
    def _sample_slice_multistep(self, noise: NoiseSource, cond: torch.Tensor, ddim: DDIMParams,
                                sampler: str, guidance_scale: float = 1.0,
                                uncond_cond: Optional[torch.Tensor] = None, x_T: Optional[torch.Tensor] = None,
                                start_index: Optional[int] = None) -> torch.Tensor:
        """The multistep ODE samplers ('plms', 'dpm') for one slice, with
        guidance as in `sample_slice` and the same `start_index` contract."""
        if sampler not in _LOOPS:
            raise ValueError(f"unknown sampler {sampler!r}; expected 'ddim', 'plms' or 'dpm'")
        self._check_sampler(sampler, None, ddim)
        b, h, w, _ = cond.shape
        if x_T is None:
            x_T = noise.normal((b, h, w, self.channels))

        def eps_fn(x, t):
            e = self.apply_model(x, t, cond=cond)
            if guidance_scale != 1.0:
                null = torch.zeros_like(cond) if uncond_cond is None else uncond_cond
                e = _guided(e, self.apply_model(x, t, cond=null), guidance_scale)
            return self._to_eps(e, x, t).to(x.dtype)

        return _LOOPS[sampler](eps_fn, ddim, x_T, start_index=start_index)

    def sample_slice_plms(self, noise: NoiseSource, cond: torch.Tensor, ddim: DDIMParams,
                          x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """PLMS variant of the slice sampler."""
        return self._sample_slice_multistep(noise, cond, ddim, "plms", x_T=x_T)

    def sample_slice_dpm(self, noise: NoiseSource, cond: torch.Tensor, ddim: DDIMParams,
                         x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """DPM-Solver++(2M) slice sampler, every slice from pure noise."""
        return self._sample_slice_multistep(noise, cond, ddim, "dpm", x_T=x_T)

    # -- full-T ancestral sampling ---------------------------------------------

    @torch.no_grad()
    def _ancestral_loop(self, noise: NoiseSource, cond: torch.Tensor, *, x_T: Optional[torch.Tensor] = None,
                        clip_denoised: bool = True, n_rows: int = 0, collect: str = "x0",
                        quantize_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """The ancestral chain over t = T-1 ... 0, one normal draw per step (at
        t = 0 too, where it is multiplied by 0).  With `n_rows`, also the rows
        at every t % max(1, T // n_rows) == 0, in sampling order: pred_x0
        (`collect='x0'`) or the walking sample ('x').  `quantize_fn` maps
        pred_x0 before the posterior.  Returns (x, rows or None)."""
        b, h, w, _ = cond.shape
        T = self.diffusion.num_timesteps
        x = noise.normal((b, h, w, self.channels)) if x_T is None else x_T
        every = max(1, T // n_rows) if n_rows else T + 1
        rows = []
        for t in range(T - 1, -1, -1):
            t_b = torch.full((b,), t, dtype=torch.int64, device=x.device)
            x0 = self.diffusion.predict_x0(self.apply_model(x, t_b, cond=cond).to(x.dtype), x, t_b, clip_denoised)
            if quantize_fn is not None:
                x0 = quantize_fn(x0)
            mean, _, log_var = self.diffusion.q_posterior(x0, x, t_b)
            eps = noise.normal(x.shape).to(x.dtype)
            x_next = mean + float(t > 0) * torch.exp(0.5 * log_var) * eps
            if n_rows and t % every == 0:
                rows.append(x0 if collect == "x0" else x_next)
            x = x_next
        return x, (torch.stack(rows) if n_rows else None)

    def p_sample_loop(self, noise: NoiseSource, cond: torch.Tensor, *, x_T: Optional[torch.Tensor] = None,
                      clip_denoised: bool = True, return_intermediates: bool = False, n_rows: int = 6,
                      quantize_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """The full-T ancestral sampler; with `return_intermediates`, also the
        walking sample at ~n_rows levels."""
        x, rows = self._ancestral_loop(noise, cond, x_T=x_T, clip_denoised=clip_denoised,
                                       n_rows=n_rows if return_intermediates else 0, collect="x",
                                       quantize_fn=quantize_fn)
        return (x, rows) if return_intermediates else x

    def progressive_denoising(self, noise: NoiseSource, cond: torch.Tensor, *, x_T: Optional[torch.Tensor] = None,
                              clip_denoised: bool = True, n_rows: int = 6,
                              quantize_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        """(sample, pred_x0 progression (n_rows, B, H, W, C)) over the full
        ancestral chain."""
        return self._ancestral_loop(noise, cond, x_T=x_T, clip_denoised=clip_denoised, n_rows=n_rows,
                                    collect="x0", quantize_fn=quantize_fn)

    # -- panels --------------------------------------------------------------------

    @torch.no_grad()
    def log_images(self, noise: NoiseSource, batch: dict, ddim: DDIMParams, n_row: int = 4,
                   progressive: bool = False) -> dict:
        """Qualitative panels as float32 numpy arrays: inputs, samples, the
        denoise row (~6 of the samples' pred_x0 steps), the diffusion row
        (q_sample of the inputs at 6 levels over [0, T-1]), inpaint and
        outpaint (the left half of W kept / regenerated) and the
        conditioning; `progressive` adds the full-T pred_x0 progression (one
        more ancestral chain).  Draws in the JAX order: the sample chain,
        inpaint, outpaint, the diffusion row, the progressive chain."""
        x = batch["image"][:n_row]
        cond = batch.get("cond")
        cond = cond[:n_row] if cond is not None else torch.zeros(x.shape[:-1] + (self.cond_channels,),
                                                                 device=x.device)
        samples, inter = self.sample_slice(noise, cond, ddim, return_intermediates=True)
        denoise_row = inter[::max(1, inter.shape[0] // 6)]
        mask = torch.zeros_like(x)
        mask[:, :, : x.shape[2] // 2] = 1.0
        inpaint = self.sample_slice(noise, cond, ddim, inpaint_mask=mask, inpaint_x0=x)
        outpaint = self.sample_slice(noise, cond, ddim, inpaint_mask=1.0 - mask, inpaint_x0=x)
        T = self.diffusion.num_timesteps
        diffusion_row = torch.stack([
            self.diffusion.q_sample(x, torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device),
                                    noise.normal(x.shape).to(x.dtype))
            for t in np.linspace(0, T - 1, num=min(6, T)).astype(np.int32)])
        out = {"inputs": x, "samples": samples, "denoise_row": denoise_row, "diffusion_row": diffusion_row,
               "inpaint": inpaint, "outpaint": outpaint, "conditioning": cond}
        if progressive:
            out["progressive_row"] = self.progressive_denoising(noise, cond, n_rows=6)[1]
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    # -- the volume ------------------------------------------------------------------

    def _volume_slice_step(self, noise: NoiseSource, prev: torch.Tensor, mask_slice: torch.Tensor,
                           ddim: DDIMParams, tile: Optional[Tile] = None, guidance_scale: float = 1.0,
                           prev_raw: Optional[torch.Tensor] = None, warm_index: Optional[int] = None,
                           sampler: str = "ddim") -> Tuple[torch.Tensor, torch.Tensor]:
        """One autoregressive z-step: the [prev | mask] concat-conditioned
        chain, then min-max normalisation.  Returns (normalised, raw).  With
        `warm_index=k` and `prev_raw`, the previous raw slice is q-noised to
        node k-1 (a = ddim.alphas[k-1]) and only the last k nodes run."""
        cond = torch.cat([prev, mask_slice], dim=-1)
        x_T = start = None
        if warm_index is not None and prev_raw is not None:
            a = ddim.alphas[warm_index - 1]
            eps = noise.normal(prev_raw.shape).to(prev_raw.dtype)
            x_T = float(np.sqrt(a)) * prev_raw + float(np.sqrt(np.float32(1.0) - a)) * eps
            start = warm_index
        if sampler != "ddim":
            s = self._sample_slice_multistep(noise, cond, ddim, sampler, guidance_scale=guidance_scale,
                                             x_T=x_T, start_index=start)
        else:
            s = self.sample_slice(noise, cond, ddim, tile=tile, guidance_scale=guidance_scale, x_T=x_T,
                                  start_index=start)
        return _minmax_slice(s), s

    @torch.no_grad()
    def stream_volume(self, noise: NoiseSource, mask_volume: torch.Tensor, ddim: DDIMParams,
                      init_slice: Optional[torch.Tensor] = None, tile: Optional[Tile] = None,
                      guidance_scale: float = 1.0, warm_start: Optional[float] = None,
                      sampler: str = "ddim") -> Iterator[torch.Tensor]:
        """Yield the (B, H, W, C) slices of a (B, D, H, W, 1) mask channel one
        at a time, autoregressively.  The first slice is conditioned on
        `init_slice` (zeros by default) and always runs the full chain;
        `warm_start=f` in (0, 1] runs the later slices' last round(f * S)
        nodes from the previous raw slice q-noised to that level.  `sampler`
        is 'ddim', 'plms' or 'dpm' (eta 0; `tile` is DDIM's only)."""
        self._check_sampler(sampler, tile, ddim)
        warm = self.warm_start_index(ddim, warm_start)
        b, d, h, w, _ = mask_volume.shape
        prev = (torch.zeros((b, h, w, self.channels), device=mask_volume.device)
                if init_slice is None else init_slice)
        prev_raw = None
        for z in range(d):
            prev, prev_raw = self._volume_slice_step(
                noise, prev, mask_volume[:, z], ddim, tile=tile, guidance_scale=guidance_scale,
                prev_raw=prev_raw, warm_index=warm if z > 0 else None, sampler=sampler)
            yield prev

    def sample_volume(self, noise: NoiseSource, mask_volume: torch.Tensor, ddim: DDIMParams,
                      init_slice: Optional[torch.Tensor] = None, tile: Optional[Tile] = None,
                      guidance_scale: float = 1.0, warm_start: Optional[float] = None,
                      sampler: str = "ddim") -> torch.Tensor:
        """All D slices of `stream_volume`, stacked: (B, D, H, W, C)."""
        return torch.stack(list(self.stream_volume(noise, mask_volume, ddim, init_slice=init_slice, tile=tile,
                                                   guidance_scale=guidance_scale, warm_start=warm_start,
                                                   sampler=sampler)), dim=1)
