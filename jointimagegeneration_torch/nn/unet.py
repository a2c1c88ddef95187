"""Guided-diffusion UNet, 2D and 3D, channels-last.

Counterpart of `jointimagegeneration_tpu/nn/unet.py` for the sampling path:
  * stage 1: the 3D categorical mask denoiser (base 64, mult (1,2,2,4,5),
    head channels 32, softmax x0 head);
  * stage 2: the 2D slice eps-denoiser (base 128, mult (1,2,4,4,5)).

Submodules carry the JAX package's flax names (`in_conv`, `down_0_0_res`,
`down_3_0_attn`, `down_0_ds`, `mid_res1`, `up_3_us`, `out_conv`, ...), so
`utils.jax_weights` maps a flax parameter tree onto this module by name.

Precision follows the JAX package: fp32 params cast per op; an fp32 time MLP
whose output is cast to the torso dtype; the torso in `dtype` (bf16 on the
main path); an fp32 head.  Not ported here: cross-attention `context`, class
ids `y`, `feature_cond` injection, rematerialisation, and the UNet-level
`use_scale_shift_norm` / `resblock_updown` / `num_heads` options (ResBlock
itself has scale-shift and up/down).

`use_fused_resblock` (False | 'xla' | 'kernel' | True) and `use_pallas_conv`
are the JAX UNet's opt-in kernel paths (nn/unet.py:91-94 there), passed to
every ResBlock in 3D and ignored in 2D, as there; no config key turns them on.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.runtime import resolve_device
from .blocks import AttentionBlock, Conv, Downsample, GroupNorm32, Linear, ResBlock, Upsample, timestep_embedding

__all__ = ["UNet", "init_weights", "ZERO_INIT_SUFFIXES"]

# parameters the JAX package initialises to zero (nn/blocks.py:209,319; nn/unet.py:229)
ZERO_INIT_SUFFIXES = ("conv2_kernel", "proj_out.weight", "out_conv.weight")


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers: norm scales one, biases zero, the
    zero-init kernels zero, every other kernel lecun-normal (truncated normal
    with variance 1/fan_in)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:  # GroupNorm scales
                p.fill_(1.0)
            elif name.endswith(ZERO_INIT_SUFFIXES):
                p.zero_()
            else:
                fan_in = p.shape[1] * math.prod(p.shape[2:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std, generator=generator)


class UNet(nn.Module):
    """Returns the output head's values (or softmax probabilities over
    `out_channels`) in channels-last layout.  `in_channels` counts the input
    plus the concatenated `cond` channels."""

    def __init__(
        self,
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (32, 16, 8),
        channel_mult: Sequence[int] = (1, 2, 2, 4, 5),
        dims: int = 3,
        num_head_channels: int = 32,
        softmax_output: bool = False,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 0,
        use_pallas_conv: bool = False,
        use_fused_resblock=False,
    ):
        super().__init__()
        device = resolve_device(device)
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.softmax_output = softmax_output
        self.dtype = dtype
        mc = model_channels
        emb_ch = mc * 4
        res = dict(emb_ch=emb_ch, dims=dims, device=device, pallas_conv=use_pallas_conv and dims == 3,
                   fused=use_fused_resblock if dims == 3 else False)

        def attn(ch: int) -> AttentionBlock:
            return AttentionBlock(ch, num_head_channels=num_head_channels, device=device)

        self.time_embed_0 = Linear(mc, emb_ch, device=device)
        self.time_embed_1 = Linear(emb_ch, emb_ch, device=device)
        ch = mc * channel_mult[0]
        self.in_conv = Conv(in_channels, ch, 3, dims, device=device)
        skip_ch = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}_res", ResBlock(ch, int(mult * mc), **res))
                ch = int(mult * mc)
                if ds in self.attention_resolutions:
                    self.add_module(f"down_{level}_{i}_attn", attn(ch))
                skip_ch.append(ch)
            if level != len(channel_mult) - 1:
                self.add_module(f"down_{level}_ds", Downsample(ch, dims, device=device))
                skip_ch.append(ch)
                ds *= 2
        self.mid_res1 = ResBlock(ch, ch, **res)
        self.mid_attn = attn(ch)
        self.mid_res2 = ResBlock(ch, ch, **res)
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}_res", ResBlock(ch + skip_ch.pop(), int(mult * mc), **res))
                ch = int(mult * mc)
                if ds in self.attention_resolutions:
                    self.add_module(f"up_{level}_{i}_attn", attn(ch))
                if level and i == num_res_blocks:
                    self.add_module(f"up_{level}_us", Upsample(ch, dims, device=device))
                    ds //= 2
        self.out_norm = GroupNorm32(ch, device=device)
        self.out_conv = Conv(ch, out_channels, 3, dims, device=device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        init_weights(self, generator)

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        return block(h, emb) if isinstance(block, ResBlock) else block(h)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        context: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        feature_cond: Optional[dict] = None,
    ) -> torch.Tensor:
        if context is not None or y is not None or feature_cond is not None:
            raise NotImplementedError("UNet: context, y and feature_cond are not ported")
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_1(F.silu(self.time_embed_0(emb)))
        emb = emb.to(self.dtype)
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        in_dtype = x.dtype
        h = self.in_conv(x.to(self.dtype))
        hs = [h]
        ds = 1
        n_levels = len(self.channel_mult)
        for level in range(n_levels):
            for i in range(self.num_res_blocks):
                h = self._block(f"down_{level}_{i}_res", h, emb)
                if ds in self.attention_resolutions:
                    h = self._block(f"down_{level}_{i}_attn", h, emb)
                hs.append(h)
            if level != n_levels - 1:
                h = self._block(f"down_{level}_ds", h, emb)
                hs.append(h)
                ds *= 2
        h = self.mid_res2(self.mid_attn(self.mid_res1(h, emb)), emb)
        for level in reversed(range(n_levels)):
            for i in range(self.num_res_blocks + 1):
                h = self._block(f"up_{level}_{i}_res", torch.cat([h, hs.pop()], dim=-1), emb)
                if ds in self.attention_resolutions:
                    h = self._block(f"up_{level}_{i}_attn", h, emb)
                if level and i == self.num_res_blocks:
                    h = self._block(f"up_{level}_us", h, emb)
                    ds //= 2
        h = F.silu(self.out_norm(h.float()))
        h = self.out_conv(h)
        if self.softmax_output:
            h = torch.softmax(h, dim=-1)
        return h.to(in_dtype) if in_dtype != torch.float32 else h
