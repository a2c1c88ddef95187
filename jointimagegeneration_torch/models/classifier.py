"""Noisy-latent classifier, for classifier guidance of the Gaussian sampler.

Counterpart of `jointimagegeneration_tpu/models/classifier.py`: the encoder
half of the UNet (`_EncoderUNet`: the time MLP, `in_conv`, `down_{level}_{i}`
ResBlocks, `down_{level}_ds` downsamples, `out_norm`, a mean pool over the
spatial axes, the `head` Dense) trained on q_sample(x0, t) at uniform t.
The submodules carry the flax names, so `utils.jax_weights.
unet_state_dict_from_jax` maps a JAX classifier tree by name.  It computes in
fp32, as the flax module (no `dtype`) does.

`NoisyLatentClassifier.loss` draws t, then the noise, from the caller's
`NoiseSource` (the JAX keys `kt, kn`).  `guidance_fn` returns
g(x, t) = scale * d/dx sum_b log_softmax(logits)[b, target], through
`torch.autograd.grad` with grad enabled (and inference mode off) inside the
function, so a sampler running under `torch.no_grad` can call it;
`SliceLDM.sample_slice(guidance_fn=...)` subtracts sqrt(1 - alpha) * g from
its eps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.runtime import resolve_device
from ..diffusion.gaussian import GaussianDiffusion
from ..diffusion.noise import NoiseSource
from ..nn.blocks import Conv, Downsample, GroupNorm32, Linear, ResBlock, timestep_embedding
from ..nn.unet import init_weights

__all__ = ["EncoderUNet", "NoisyLatentClassifier"]


class EncoderUNet(nn.Module):
    """(B, *spatial, in_channels) noisy input and (B,) timesteps -> (B,
    num_classes) logits."""

    def __init__(self, in_channels: int, model_channels: int, num_classes: int,
                 channel_mult: Sequence[int] = (1, 2, 4), num_res_blocks: int = 1, dims: int = 2,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        mc, emb_ch = model_channels, model_channels * 4
        self.model_channels, self.channel_mult, self.num_res_blocks = mc, tuple(channel_mult), num_res_blocks
        self.time_embed_0 = Linear(mc, emb_ch, device=device)
        self.time_embed_1 = Linear(emb_ch, emb_ch, device=device)
        ch = mc * self.channel_mult[0]
        self.in_conv = Conv(in_channels, ch, 3, dims, device=device)
        for level, mult in enumerate(self.channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}", ResBlock(ch, int(mult * mc), emb_ch, dims, device=device))
                ch = int(mult * mc)
            if level != len(self.channel_mult) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch, dims, device=device))
        self.out_norm = GroupNorm32(ch, device=device)
        self.head = Linear(ch, num_classes, device=device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_1(F.silu(self.time_embed_0(emb)))
        h = self.in_conv(x)
        for level in range(len(self.channel_mult)):
            for i in range(self.num_res_blocks):
                h = getattr(self, f"down_{level}_{i}")(h, emb)
            if level != len(self.channel_mult) - 1:
                h = getattr(self, f"down_{level}_ds")(h)
        h = F.silu(self.out_norm(h))
        h = h.mean(dim=tuple(range(1, h.ndim - 1)))  # adaptive average pool
        return self.head(h)


@dataclass(frozen=True)
class NoisyLatentClassifier:
    net: EncoderUNet
    diffusion: GaussianDiffusion

    @classmethod
    def create(cls, num_classes: int, diffusion: GaussianDiffusion, model_channels: int = 32,
               channel_mult: Sequence[int] = (1, 2, 4), dims: int = 2, in_channels: int = 1,
               device=None, seed: int = 0) -> "NoisyLatentClassifier":
        """`in_channels` is the noisy input's width (flax reads it from the
        init call's `channels`)."""
        return cls(net=EncoderUNet(in_channels, model_channels, num_classes, channel_mult, dims=dims,
                                   device=device, seed=seed),
                   diffusion=diffusion)

    def loss(self, noise: NoiseSource, x0: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy of the logits of x_t at t ~ U[0, T), and accuracy."""
        t = noise.randint(0, self.diffusion.num_timesteps, (x0.shape[0],)).to(x0.device)
        eps = noise.normal(x0.shape).to(device=x0.device, dtype=x0.dtype)
        logits = self.net(self.diffusion.q_sample(x0, t, eps), t.float())
        labels = labels.to(device=logits.device, dtype=torch.long)
        loss = -(F.log_softmax(logits, dim=-1) * F.one_hot(labels, logits.shape[-1])).sum(-1).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "acc": acc}

    def guidance_fn(self, target_label: int, scale: float = 1.0) -> Callable:
        """(x, t) -> scale * grad_x sum_b log p(target | x_t), x's shape and
        dtype."""

        def grad_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode(False), torch.enable_grad():
                xg = x.detach().clone().requires_grad_(True)
                logits = self.net(xg, t.detach().clone().float())
                logp = F.log_softmax(logits, dim=-1)[:, target_label].sum()
                (g,) = torch.autograd.grad(logp, xg)
            return scale * g

        return grad_fn
