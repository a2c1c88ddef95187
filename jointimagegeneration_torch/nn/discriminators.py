"""PatchGAN discriminators, 2D and 3D, channels-last.

Counterpart of `jointimagegeneration_tpu/nn/discriminators.py`: the
NLayerDiscriminator pyramid of the reference's
`ldm/modules/losses/contperceptual.py:296-406` — k = 4 convs with an explicit
symmetric pad of 1 (stride 2 for the first `n_layers`, then stride 1),
leaky ReLU 0.2, channel mult capped at 8, a 1-channel logit map.  Like the
JAX package it normalises with GroupNorm32 (gcd(C, 32) groups, eps 1e-5), not
the reference's BatchNorm.  `return_features` also returns each layer's
activation, for the GAN feature-matching loss.  The convs are stock cuDNN
convs: the JAX package computes them through XLA, not a Pallas kernel.

Parameter names follow the flax tree (`conv0`, `conv1`, `norm1`, ...,
`head`), so the weight bridge (`utils/jax_weights.ae_state_dict_from_jax`)
loads a JAX discriminator's parameters.  A fresh one is initialised as the
JAX package's initialisers would (lecun-normal kernels, zero biases, unit
norm scales) from `seed`; its numbers differ from a flax init's.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..core.runtime import resolve_device
from .blocks import Conv, GroupNorm32
from .unet import init_weights

__all__ = ["PatchDiscriminator"]


class PatchDiscriminator(nn.Module):
    def __init__(self, in_channels: int, dims: int = 2, ndf: int = 64, n_layers: int = 3, device=None,
                 seed: int = 2):
        super().__init__()
        device = resolve_device(device)
        self.dims, self.n_layers = dims, n_layers
        self.conv0 = Conv(in_channels, ndf, 4, dims, stride=2, padding=1, device=device)
        ch = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            self.add_module(f"conv{n}", Conv(ch, out, 4, dims, stride=2, padding=1, device=device))
            self.add_module(f"norm{n}", GroupNorm32(out, device=device))
            ch = out
        out = ndf * min(2 ** n_layers, 8)
        self.add_module(f"conv{n_layers}", Conv(ch, out, 4, dims, stride=1, padding=1, device=device))
        self.add_module(f"norm{n_layers}", GroupNorm32(out, device=device))
        self.head = Conv(out, 1, 4, dims, stride=1, padding=1, device=device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        init_weights(self, generator)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        # k = 4 convs with pad 1: the input must survive n_layers stride-2
        # stages and two stride-1 stages without collapsing to an empty map
        min_size = 2 ** self.n_layers * 4
        spatial = tuple(x.shape[1:-1])
        if min(spatial) < min_size:
            raise ValueError(f"PatchDiscriminator(n_layers={self.n_layers}) needs spatial >= {min_size}, got "
                             f"{spatial}; reduce n_layers for small images")
        feats: List[torch.Tensor] = []
        h = F.leaky_relu(self.conv0(x), 0.2)
        feats.append(h)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(h))
            h = F.leaky_relu(h, 0.2)
            feats.append(h)
        logits = self.head(h)
        return (logits, feats) if return_features else logits
