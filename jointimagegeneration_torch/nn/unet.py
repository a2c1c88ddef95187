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
main path); an fp32 head.

With `context_dim` set, every attention site is a `SequenceTransformer` of
`transformer_depth` blocks whose `attn2` attends over the `context` (B, T,
context_dim) that `forward` casts to the torso dtype and hands to each site
(the text-guided stage-1 UNet); without it a context is ignored, as the flax
UNet ignores it.  flax sizes each `attn2`'s `to_k` / `to_v` from what the
init call passes: a tree initialised without a context shape (the JAX
CLIs' stage-2 init) takes the site's own width there, and attends over x.
`context_free=True` builds that tree (torch shapes are not lazy); it then
takes no context.

`feature_cond` = {idx: (B, *spatial_at_site, F)} concatenates dense
extractor features (the 'dino' encoder's) onto the activation, in its dtype,
before encoder site `idx`: 0 is the stem (before `in_conv`), each ResBlock
advances the index by one and so does each down-transition.  Torch shapes
are not lazy, so the constructor takes the widths, `feature_cond_channels` =
{idx: F}, and sizes the layers after each site: the ResBlock there takes F
more channels; at a down-transition its conv keeps the widened width, so
the skip it pushes, the next level's first ResBlock and the decoder ResBlock
that pops that skip all take F more.

`adm_classes` ('adm' class conditioning) adds an fp32 `label_emb`
embedding of the class ids `y` to the time embedding before its cast to the
torso dtype; the forward raises without `y`, as the JAX UNet's assert.

`remat` rematerialises every ResBlock under autograd (or those of the levels
in `remat_levels`; the middle block counts as the last level), attention
sites never, as the JAX UNet's `nn.remat`: with `remat_policy=None` whole
blocks, with 'conv_outputs' only the glue between the convs (see
`nn.blocks.ResBlock`).  Any other policy raises ValueError.

Not ported here: the UNet-level `dropout` (no config sets it; ResBlock itself
has it), `use_scale_shift_norm` / `resblock_updown` / `num_heads` options
(ResBlock itself has scale-shift and up/down) and `spatial_axis`.

`use_fused_resblock` (False | 'xla' | 'kernel' | True) and `use_pallas_conv`
are the JAX UNet's opt-in kernel paths (nn/unet.py:91-94 there), passed to
every ResBlock in 3D and ignored in 2D, as there; no config key turns them on.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.runtime import resolve_device
from .blocks import AttentionBlock, Conv, Downsample, GroupNorm32, Linear, ResBlock, Upsample, timestep_embedding
from .transformer import SequenceTransformer

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
        context_dim: Optional[int] = None,
        transformer_depth: int = 1,
        feature_cond_channels: Optional[Dict[int, int]] = None,
        adm_classes: Optional[int] = None,
        context_free: bool = False,
        remat: bool = False,
        remat_levels: Optional[Sequence[int]] = None,
        remat_policy: Optional[str] = None,
    ):
        super().__init__()
        if remat_policy not in (None, "conv_outputs"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        device = resolve_device(device)
        self.adm_classes = adm_classes
        self.model_channels = model_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.softmax_output = softmax_output
        self.dtype = dtype
        self.context_dim = context_dim
        fc = self.feature_cond_channels = dict(feature_cond_channels or {})
        mc = model_channels
        emb_ch = mc * 4
        res_kw = dict(emb_ch=emb_ch, dims=dims, device=device, pallas_conv=use_pallas_conv and dims == 3,
                      fused=use_fused_resblock if dims == 3 else False)
        block_remat = "full" if remat_policy is None else remat_policy

        def res(level: int) -> dict:
            on = remat and (remat_levels is None or level in remat_levels)
            return dict(res_kw, remat=block_remat if on else None)

        def attn(ch: int) -> nn.Module:
            if context_dim is None:
                return AttentionBlock(ch, num_head_channels=num_head_channels, device=device)
            heads = max(1, ch // num_head_channels)
            return SequenceTransformer(ch, heads, ch // heads, depth=transformer_depth,
                                       context_dim=None if context_free else context_dim, device=device)

        self.time_embed_0 = Linear(mc, emb_ch, device=device)
        self.time_embed_1 = Linear(emb_ch, emb_ch, device=device)
        if adm_classes is not None:
            self.label_emb = nn.Embedding(adm_classes, emb_ch, device=device)
        ch = mc * channel_mult[0]
        self.in_conv = Conv(in_channels + fc.get(0, 0), ch, 3, dims, device=device)
        skip_ch = [ch]
        ds, block_idx = 1, 1
        for level, mult in enumerate(channel_mult):
            for i in range(num_res_blocks):
                self.add_module(f"down_{level}_{i}_res", ResBlock(ch + fc.get(block_idx, 0), int(mult * mc), **res(level)))
                ch = int(mult * mc)
                if ds in self.attention_resolutions:
                    self.add_module(f"down_{level}_{i}_attn", attn(ch))
                skip_ch.append(ch)
                block_idx += 1
            if level != len(channel_mult) - 1:
                ch += fc.get(block_idx, 0)  # the down-transition keeps the widened width
                self.add_module(f"down_{level}_ds", Downsample(ch, dims, device=device))
                skip_ch.append(ch)
                ds *= 2
                block_idx += 1
        if set(fc) - set(range(block_idx)):
            raise ValueError(f"feature_cond_channels sites {sorted(fc)} beyond the encoder's {block_idx} "
                             "(0 = the stem)")
        self.mid_res1 = ResBlock(ch, ch, **res(len(channel_mult) - 1))
        self.mid_attn = attn(ch)
        self.mid_res2 = ResBlock(ch, ch, **res(len(channel_mult) - 1))
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                self.add_module(f"up_{level}_{i}_res", ResBlock(ch + skip_ch.pop(), int(mult * mc), **res(level)))
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

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor,
               context: Optional[torch.Tensor] = None) -> torch.Tensor:
        block = getattr(self, name)
        if isinstance(block, ResBlock):
            return block(h, emb)
        return block(h, context) if isinstance(block, SequenceTransformer) else block(h)

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        context: Optional[torch.Tensor] = None,
        y: Optional[torch.Tensor] = None,
        feature_cond: Optional[dict] = None,
    ) -> torch.Tensor:
        if self.adm_classes is not None and y is None:
            raise ValueError("UNet: adm_classes set but no class ids `y` given")
        if set(feature_cond or {}) != set(self.feature_cond_channels):
            raise ValueError(f"UNet built for feature_cond sites {sorted(self.feature_cond_channels)}, given "
                             f"{sorted(feature_cond or {})}")

        def inject(h: torch.Tensor, idx: int) -> torch.Tensor:
            if feature_cond is not None and idx in feature_cond:
                h = torch.cat([h, feature_cond[idx].to(h.dtype)], dim=-1)
            return h

        context = None if context is None or self.context_dim is None else context.to(self.dtype)
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed_1(F.silu(self.time_embed_0(emb)))
        if self.adm_classes is not None:
            emb = emb + self.label_emb(y.to(device=emb.device, dtype=torch.long))
        emb = emb.to(self.dtype)
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        in_dtype = x.dtype
        h = self.in_conv(inject(x.to(self.dtype), 0))
        hs = [h]
        ds, block_idx = 1, 1
        n_levels = len(self.channel_mult)
        for level in range(n_levels):
            for i in range(self.num_res_blocks):
                h = self._block(f"down_{level}_{i}_res", inject(h, block_idx), emb)
                if ds in self.attention_resolutions:
                    h = self._block(f"down_{level}_{i}_attn", h, emb, context)
                hs.append(h)
                block_idx += 1
            if level != n_levels - 1:
                h = self._block(f"down_{level}_ds", inject(h, block_idx), emb)
                hs.append(h)
                ds *= 2
                block_idx += 1
        h = self.mid_res2(self._block("mid_attn", self.mid_res1(h, emb), emb, context), emb)
        for level in reversed(range(n_levels)):
            for i in range(self.num_res_blocks + 1):
                h = self._block(f"up_{level}_{i}_res", torch.cat([h, hs.pop()], dim=-1), emb)
                if ds in self.attention_resolutions:
                    h = self._block(f"up_{level}_{i}_attn", h, emb, context)
                if level and i == self.num_res_blocks:
                    h = self._block(f"up_{level}_us", h, emb)
                    ds //= 2
        h = F.silu(self.out_norm(h.float()))
        h = self.out_conv(h)
        if self.softmax_output:
            h = torch.softmax(h, dim=-1)
        return h.to(in_dtype) if in_dtype != torch.float32 else h
