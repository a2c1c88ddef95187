"""First-stage autoencoders: AutoencoderKL and VQModel, 2D and 3D.

Counterpart of `jointimagegeneration_tpu/models/autoencoder.py` for the
sampling path.  The modules hold fp32 weights and compute in fp32 whatever
the diffusion UNet's dtype: the JAX modules set no `dtype`, so flax computes
them against their fp32 params.  A fresh module is initialised as the JAX
package's initialisers would (norm scales one, biases zero, `proj_out`
zero, kernels lecun-normal, the codebook uniform in [-1/n, 1/n)) from
`seed`; its numbers differ from a flax init's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..core.runtime import resolve_device
from ..diffusion.noise import NoiseSource
from ..nn.blocks import Conv
from ..nn.unet import init_weights
from ..nn.vae import Decoder, Encoder, VectorQuantizer

__all__ = ["DiagonalGaussian", "AutoencoderKL", "VQModel"]


class DiagonalGaussian(NamedTuple):
    """The encoder's moments (..., 2C) as mean and log-variance."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean, torch.clamp(logvar, -30.0, 20.0))

    def sample(self, noise: NoiseSource) -> torch.Tensor:
        return self.mean + torch.exp(0.5 * self.logvar) * noise.normal(self.mean.shape).to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL to N(0, I), summed over the non-batch axes."""
        val = 0.5 * (self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar)
        return val.sum(dim=tuple(range(1, val.ndim)))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        val = 0.5 * (math.log(2.0 * math.pi) + self.logvar + (sample - self.mean) ** 2 / torch.exp(self.logvar))
        return val.sum(dim=tuple(range(1, val.ndim)))


class _Autoencoder(nn.Module):
    def __init__(self, *, embed_dim: int, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 attn_resolutions: Sequence[int], z_channels: int, in_channels: int, out_ch: int, dims: int,
                 resolution: int, attn_type: str, double_z: bool, moments: int, device, seed: int):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim, self.z_channels = embed_dim, z_channels
        self.in_channels, self.out_ch, self.ch_mult = in_channels, out_ch, tuple(ch_mult)
        common = dict(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks, attn_resolutions=tuple(attn_resolutions),
                      z_channels=z_channels, dims=dims, resolution=resolution, attn_type=attn_type, device=device)
        self.encoder = Encoder(in_channels=in_channels, double_z=double_z, **common)
        self.decoder = Decoder(out_ch=out_ch, **common)
        z_out = 2 * z_channels if double_z else z_channels
        self.quant_conv = Conv(z_out, moments, 1, dims, device=device)
        self.post_quant_conv = Conv(embed_dim, z_channels, 1, dims, device=device)

    def _init(self, seed: int) -> None:
        generator = torch.Generator(device=self.quant_conv.weight.device)
        generator.manual_seed(seed)
        init_weights(self, generator)

    @property
    def downsample_factor(self) -> int:
        """The spatial factor between pixel and latent space (one 2x per level)."""
        return 2 ** (len(self.ch_mult) - 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


class AutoencoderKL(_Autoencoder):
    """encode -> quant_conv -> DiagonalGaussian; decode <- post_quant_conv."""

    def __init__(self, embed_dim: int = 4, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (), z_channels: int = 4,
                 in_channels: int = 1, out_ch: int = 1, dims: int = 2, resolution: int = 512,
                 attn_type: str = "vanilla", device=None, seed: int = 3):
        super().__init__(embed_dim=embed_dim, ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                         attn_resolutions=attn_resolutions, z_channels=z_channels, in_channels=in_channels,
                         out_ch=out_ch, dims=dims, resolution=resolution, attn_type=attn_type, double_z=True,
                         moments=2 * embed_dim, device=device, seed=seed)
        self._init(seed)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def forward(self, x: torch.Tensor, noise: Optional[NoiseSource] = None):
        """(reconstruction, posterior): decoded from a posterior sample when a
        noise source is given, else from its mode."""
        posterior = self.encode(x)
        z = posterior.mode() if noise is None else posterior.sample(noise)
        return self.decode(z), posterior


class VQModel(_Autoencoder):
    """Quantized autoencoder.  As an LDM first stage the diffusion runs in the
    continuous pre-quantization latent: `encode_prequant` stops before the
    codebook, `decode_prequant` goes through it."""

    def __init__(self, embed_dim: int = 4, n_embed: int = 8192, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (), z_channels: int = 4,
                 in_channels: int = 1, out_ch: int = 1, dims: int = 2, resolution: int = 256,
                 attn_type: str = "vanilla", device=None, seed: int = 3):
        super().__init__(embed_dim=embed_dim, ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                         attn_resolutions=attn_resolutions, z_channels=z_channels, in_channels=in_channels,
                         out_ch=out_ch, dims=dims, resolution=resolution, attn_type=attn_type, double_z=False,
                         moments=embed_dim, device=device, seed=seed)
        self.quantize = VectorQuantizer(n_embed=n_embed, embed_dim=embed_dim,
                                        device=self.quant_conv.weight.device)
        self._init(seed)
        generator = torch.Generator(device=self.quant_conv.weight.device)
        generator.manual_seed(seed + 1)
        with torch.no_grad():
            self.quantize.codebook.uniform_(-1.0 / n_embed, 1.0 / n_embed, generator=generator)

    def encode(self, x: torch.Tensor):
        """(zq, quantization loss, indices)."""
        return self.quantize(self.encode_prequant(x))

    def encode_prequant(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x))

    def decode_prequant(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        return self.decode(h if force_not_quantize else self.quantize(h)[0])

    def forward(self, x: torch.Tensor):
        zq, qloss, idx = self.encode(x)
        return self.decode(zq), qloss, idx
