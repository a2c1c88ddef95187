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
has it) and the `use_scale_shift_norm` / `resblock_updown` / `num_heads`
options (ResBlock itself has scale-shift and up/down).

`mesh` (`parallel.mesh.Mesh`) and `spatial_axis` are the JAX UNet's mesh
placement (`P("data", spatial_axis, None, ...)` on its activations), passed
explicitly where JAX reads the mesh of a `with mesh:` block; `set_mesh`
changes them.  The forward takes whole tensors and returns a whole one on
the input's device.  A batch's rows are cut over the data axis
(`parallel.mesh.shard_batch`), each row of the mesh running on its own
devices with its copy of the weights (`parallel.mesh.replicate`, once per
device, made again when the weights change); no gradient reaches this
module through a copy, so a mesh with rows on other devices runs only
without autograd (ValueError otherwise: the trainers' data axis is
torchrun's).  With `spatial_axis="model"` a row's activations are also
split along their leading spatial axis (D in 3D, H in 2D) over its 'model'
devices, after the `cond` concatenation; the parameters of a shard's ops
move to its device per call (free where the device repeats), so a
sharded step's gradients land on the row's module.  Every block takes the
shards (`nn.blocks`, `parallel/spatial.py`), `feature_cond` maps are split at
their sites and the skips stay sharded.  A level is sharded while its
extent splits into equal shards, even ones where a Downsample follows (a
shard that starts at an odd index would need the plane after it too);
deeper levels run gathered on the row's first device and are split again
on the way up.  The fp32 head runs on the shards, which are gathered after
it.  Sharding adds no parameter: the same state dict loads either way.
`spatial_axis` without a mesh raises ValueError, and so does a 'model' axis
wider than 1 without `spatial_axis`.

`use_fused_resblock` (False | 'xla' | 'kernel' | True) and `use_pallas_conv`
are the JAX UNet's opt-in kernel paths (nn/unet.py:91-94 there), passed to
every ResBlock in 3D and ignored in 2D, as there; no config key turns them on.

Spans (`core.logging.span`, recorded only while the recorder is on): `unet`
around a call, `unet.head` (the time embedding and `in_conv`), one
`unet.<block>` per block in calling order (`unet.down_0_0_res`, ...,
`unet.mid_res1`, `unet.mid_attn`, `unet.mid_res2`, ..., `unet.up_0_2_res`),
and `unet.tail` (`out_norm`, SiLU, `out_conv`, the softmax); card events
except on a sharded 'model' axis.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.logging import span
from ..core.runtime import resolve_device
from ..parallel import spatial
from ..parallel.mesh import Mesh, replicate, shard_batch
from ..parallel.spatial import Sharded, each
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
        spatial_axis: Optional[str] = None,
        mesh: Optional[Mesh] = None,
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
        self._span_names = {name: f"unet.{name}" for name, _ in self.named_children()}
        self._replicas, self._replica_version = {}, None
        self.set_mesh(mesh, spatial_axis)

    def set_mesh(self, mesh: Optional[Mesh] = None, spatial_axis: Optional[str] = None) -> None:
        """Run later calls over `mesh` (None: on this module's device), with
        the activations sharded over its 'model' axis when `spatial_axis` is
        "model" (see the module docstring)."""
        if spatial_axis is not None and mesh is None:
            raise ValueError("UNet: spatial_axis needs a mesh")
        if spatial_axis not in (None, "model"):
            raise ValueError(f"UNet: spatial_axis must be the mesh's 'model' axis, got {spatial_axis!r}")
        if mesh is not None and mesh.shape["model"] > 1 and spatial_axis is None:
            raise ValueError(f"UNet: a {mesh.shape} mesh shards activations only with spatial_axis='model'")
        self.mesh, self.spatial_axis = mesh, spatial_axis

    def _replica(self, device: torch.device) -> "UNet":
        """This module's copy on `device` (itself on its own device), kept
        across meshes and made again after an in-place change of any
        parameter (a load, an optimizer step).  Parameters made in inference
        mode count no changes, so a module built there keeps its copies."""
        version = sum(p._version for p in self.parameters() if not p.is_inference())
        copies = self._replicas if version == self._replica_version else {}
        self._replicas = {}  # a copy carries none of the others
        if device not in copies:
            copies.update(replicate(Mesh([[device]]), self))
        self._replicas, self._replica_version = copies, version
        return copies[device]

    def _sharded_levels(self, extent: int, k: int) -> list:
        """Per level, whether it runs sharded over k devices, from the input's
        leading spatial extent."""
        out = []
        for level in range(len(self.channel_mult)):
            last = level == len(self.channel_mult) - 1
            out.append(k > 1 and extent % k == 0 and (last or extent // k % 2 == 0) and all(out))
            extent = (extent + 1) // 2
        return out

    def _block(self, name: str, h: torch.Tensor, emb: torch.Tensor,
               context: Optional[torch.Tensor] = None, card: bool = True) -> torch.Tensor:
        block = getattr(self, name)
        with span(self._span_names[name], card):
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
        with span("unet", self.spatial_axis is None):
            return self._call(x, timesteps, cond, context, y, feature_cond)

    def _call(self, x, timesteps, cond, context, y, feature_cond) -> torch.Tensor:
        mesh = self.mesh
        if mesh is None or mesh.devices == [[self.time_embed_0.weight.device]]:
            return self._run(x, timesteps, cond, context, y, feature_cond, None)
        if torch.is_grad_enabled() and any(row[0] != self.time_embed_0.weight.device for row in mesh.devices):
            raise ValueError(f"UNet: the rows of {mesh} on other devices run weight copies, which no gradient "
                             "reaches; call it without autograd (train data-parallel over torchrun)")
        sites = sorted(feature_cond or {})
        cut = [[None] * len(mesh.devices) if t is None else shard_batch(mesh, t)
               for t in (x, timesteps, cond, context, y, *(feature_cond[i] for i in sites))]
        outs = []
        for r, row in enumerate(mesh.devices):
            xr, tr, cr, ctx, yr, *fc = (c[r] for c in cut)
            if xr.shape[0]:
                outs.append(self._replica(row[0])._run(xr, tr, cr, ctx, yr, dict(zip(sites, fc)) or None,
                                                       row if self.spatial_axis else None))
        return torch.cat([o.to(x.device) for o in outs]) if len(outs) > 1 else outs[0].to(x.device)

    def _run(self, x, timesteps, cond, context, y, feature_cond, devices) -> torch.Tensor:
        """The forward on x's device, sharded over `devices` (a mesh row's
        'model' devices) where the levels allow."""
        levels = self._sharded_levels(x.shape[1], len(devices) if devices else 1)
        card = devices is None

        def at(level: int, h):
            """h as `level` runs: split over the row, or whole on x's device."""
            if levels[level] and not isinstance(h, Sharded):
                return spatial.split(h, devices)
            if not levels[level] and isinstance(h, Sharded):
                return spatial.gather(h, x.device)
            return h

        def inject(h, idx: int):
            if feature_cond is not None and idx in feature_cond:
                fc = feature_cond[idx]
                fc = spatial.split(fc, h.devices) if isinstance(h, Sharded) else fc
                h = each(lambda a, f: torch.cat([a, f.to(a.dtype)], dim=-1), h, fc)
            return h

        with span("unet.head", card):
            context = None if context is None or self.context_dim is None else context.to(self.dtype)
            emb = timestep_embedding(timesteps, self.model_channels)
            emb = self.time_embed_1(F.silu(self.time_embed_0(emb)))
            if self.adm_classes is not None:
                emb = emb + self.label_emb(y.to(device=emb.device, dtype=torch.long))
            emb = emb.to(self.dtype)
            if cond is not None:
                x = torch.cat([x, cond.to(x.dtype)], dim=-1)
            in_dtype = x.dtype
            h = self.in_conv(inject(at(0, x.to(self.dtype)), 0))
        hs = [h]
        ds, block_idx = 1, 1
        n_levels = len(self.channel_mult)
        for level in range(n_levels):
            for i in range(self.num_res_blocks):
                h = self._block(f"down_{level}_{i}_res", inject(h, block_idx), emb, card=card)
                if ds in self.attention_resolutions:
                    h = self._block(f"down_{level}_{i}_attn", h, emb, context, card)
                hs.append(h)
                block_idx += 1
            if level != n_levels - 1:
                h = at(level + 1, self._block(f"down_{level}_ds", inject(h, block_idx), emb, card=card))
                hs.append(h)
                ds *= 2
                block_idx += 1
        h = self._block("mid_res1", h, emb, card=card)
        h = self._block("mid_attn", h, emb, context, card)
        h = self._block("mid_res2", h, emb, card=card)
        for level in reversed(range(n_levels)):
            for i in range(self.num_res_blocks + 1):
                h = self._block(f"up_{level}_{i}_res", each(lambda a, b: torch.cat([a, b], dim=-1), h, hs.pop()),
                                emb, card=card)
                if ds in self.attention_resolutions:
                    h = self._block(f"up_{level}_{i}_attn", h, emb, context, card)
                if level and i == self.num_res_blocks:
                    h = at(level - 1, self._block(f"up_{level}_us", h, emb, card=card))
                    ds //= 2
        with span("unet.tail", card):
            h = self.out_norm(each(lambda p: p.float(), h), silu=True)
            h = self.out_conv(h)
            if self.softmax_output:
                h = each(lambda p: torch.softmax(p, dim=-1), h)
            if isinstance(h, Sharded):
                h = spatial.gather(h, x.device)
            return h.to(in_dtype) if in_dtype != torch.float32 else h
