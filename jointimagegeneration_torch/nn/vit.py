"""The ViT feature extractor of the 'dino' condition encoder.

Counterpart of `jointimagegeneration_tpu/nn/vit.py` (the reference's DINO
ViTExtractor): a conv patch embed with an adjustable stride (VALID, so
overlapping patches when the stride is below the patch), a cls token, the
positional embedding re-interpolated to the actual patch grid, N pre-norm
blocks, and per-layer harvesting of the keys, the tokens or the attention
weights.  Submodules carry the flax names (`patch_embed`, `cls_token`,
`pos_embed`, `block_<i>.{norm1,qkv,proj,norm2,fc1,fc2}`), so
`utils.jax_weights.vit_state_dict_from_jax` maps a flax tree onto it.

As in the JAX package: LayerNorm eps 1e-6 in fp32, the tanh GELU, and the
attention as the plain attention in fp32 (`ops.attention.plain_attention`,
softmax(q k^T / sqrt(d_head)); the JAX ViT's XLA einsum, never the flash
kernel).  The pos-embed resize is `jax.image.resize(..., "bicubic")`: Keys'
cubic with a = -0.5, antialiased when it shrinks (vits8 at 128x128 takes the
28x28 grid to 16x16), which `F.interpolate` does not compute; `jax_image_resize`
contracts jax.image's per-axis weight matrices (`data.transforms`) on the
tensor's device instead.

Weights come only from a local torch checkpoint in the DINO naming
(`blocks.<i>.attn.qkv.*`, `patch_embed.proj.*`, `pos_embed`, `cls_token`,
...; `load_dino_weights`, read with `torch.load(weights_only=True)`).  Where a
tensor's shape differs from the extractor's, the JAX loader silently keeps
the init; the port raises ValueError naming the key and both shapes.  Without
weights the extractor runs from its seeded init (the feature geometry is the
same, the features are uncalibrated), drawn on the CPU so that the card and
the CPU build the same extractor from one seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.runtime import resolve_device
from ..data.transforms import _weight_matrix
from ..ops.attention import plain_attention_weights
from .blocks import Conv, Linear
from .transformer import LayerNorm
from .unet import init_weights

__all__ = ["ViT", "ViTExtractor", "jax_image_resize", "load_dino_weights", "vit_config"]

_METHODS = {"bilinear": "linear", "linear": "linear", "bicubic": "cubic", "cubic": "cubic"}


def jax_image_resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """`jax.image.resize(x, shape, method)` for 'bilinear' / 'bicubic'
    (antialiased when shrinking): each axis whose size changes contracted
    with jax.image's (n_in, n_out) float32 weight matrix, on x's device."""
    kind = _METHODS[method]
    out = x
    for ax, n_out in enumerate(shape):
        n_in = out.shape[ax]
        if n_in != n_out:
            w = torch.from_numpy(_weight_matrix(n_in, n_out, kind)).to(device=out.device, dtype=out.dtype)
            out = torch.tensordot(out.movedim(ax, -1), w, dims=1).movedim(-1, ax)
    return out


class _ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim, device=device)
        self.qkv = Linear(dim, 3 * dim, device=device)
        self.proj = Linear(dim, dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.fc1 = Linear(dim, 4 * dim, device=device)
        self.fc2 = Linear(4 * dim, dim, device=device)

    def forward(self, x: torch.Tensor, return_keys: bool = False, return_attn: bool = False):
        b, t, d = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, t, 3, self.heads, d // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B, heads, T, d_head)
        att = plain_attention_weights(q, k)  # plain_attention, its weights kept for the 'attn' facet
        o = torch.matmul(att.to(v.dtype), v).transpose(1, 2).reshape(b, t, d)
        x = x + self.proj(o)
        x = x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        extras = {}
        if return_keys:
            extras["key"] = k.transpose(1, 2).reshape(b, t, d)
        if return_attn:
            extras["attn"] = att  # (B, heads, T, T)
        return x, extras


class ViT(nn.Module):
    """The ViT trunk: (B, H, W, 3) images -> the harvested layers' maps."""

    def __init__(self, dim: int = 384, depth: int = 12, heads: int = 6, patch: int = 8, stride: int = 8,
                 pos_grid: int = 28, seed: int = 0):
        super().__init__()
        self.dim, self.depth, self.patch, self.stride, self.pos_grid = dim, depth, patch, stride, pos_grid
        self.patch_embed = Conv(3, dim, patch, 2, stride=stride, padding=0, device="cpu")
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", _ViTBlock(dim, heads, device="cpu"))
        # flax's initialisers (lecun-normal kernels, zero biases, unit norms,
        # a zero cls token, a N(0, 0.02^2) pos-embed), drawn on the CPU
        generator = torch.Generator().manual_seed(seed)
        init_weights(self, generator)
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def grid(self, h: int, w: int):
        return 1 + (h - self.patch) // self.stride, 1 + (w - self.patch) // self.stride

    def forward(self, x: torch.Tensor, harvest_layers: Sequence[int] = (11,), facet: str = "key") -> List[torch.Tensor]:
        """Per harvested layer a (B, gh, gw, dim) map of the keys or the
        tokens (the cls token dropped), or with facet 'attn' the (B, heads,
        T, T) attention weights, cls included."""
        if facet not in ("key", "token", "attn"):
            raise ValueError(f"facet must be 'key', 'token' or 'attn', got {facet!r}")
        b = x.shape[0]
        feat = self.patch_embed(x)
        gh, gw = feat.shape[1], feat.shape[2]
        tokens = feat.reshape(b, gh * gw, self.dim)
        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        pos_patch = pos_patch.reshape(1, self.pos_grid, self.pos_grid, self.dim)
        pos_patch = jax_image_resize(pos_patch, (1, gh, gw, self.dim), "bicubic").reshape(1, gh * gw, self.dim)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        tokens = tokens + torch.cat([pos_cls, pos_patch], dim=1)
        harvested = []
        for i in range(self.depth):
            want = i in harvest_layers
            tokens, extras = getattr(self, f"block_{i}")(tokens, return_keys=want and facet == "key",
                                                         return_attn=want and facet == "attn")
            if want:
                if facet == "attn":
                    harvested.append(extras["attn"])
                else:
                    src = extras["key"] if facet == "key" else tokens
                    harvested.append(src[:, 1:].reshape(b, gh, gw, self.dim))
        return harvested


def _dino_names(depth: int) -> Dict[str, str]:
    """DINO state-dict key -> the extractor's parameter name."""
    names = {"patch_embed.proj.weight": "patch_embed.weight", "patch_embed.proj.bias": "patch_embed.bias",
             "pos_embed": "pos_embed", "cls_token": "cls_token"}
    for i in range(depth):
        for src, dst in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"),
                         ("norm1", "norm1"), ("norm2", "norm2")):
            for leaf in ("weight", "bias"):
                names[f"blocks.{i}.{src}.{leaf}"] = f"block_{i}.{dst}.{leaf}"
    return names


def load_dino_weights(vit: ViT, path) -> int:
    """Copy a DINO state dict (under `state_dict` when wrapped) into `vit`,
    as the JAX loader takes it: a block's tensors where its
    `attn.qkv.weight` is there, the patch embed where `proj.weight` is,
    `pos_embed` and `cls_token` where present.  Raises ValueError on a
    tensor whose shape differs.  Returns the count of tensors copied."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    names = _dino_names(vit.depth)
    take = [k for k in ("pos_embed", "cls_token") if k in sd]
    anchors = [(f"blocks.{i}.", "attn.qkv.weight") for i in range(vit.depth)] + [("patch_embed.", "proj.weight")]
    for pre, anchor in anchors:
        if pre + anchor in sd:
            take += [k for k in names if k.startswith(pre)]
    own = dict(vit.named_parameters())
    with torch.no_grad():
        for src in take:
            dst, t = names[src], sd[src]
            if tuple(t.shape) != tuple(own[dst].shape):
                raise ValueError(f"{path}: {src} has shape {tuple(t.shape)}, the extractor's {dst} "
                                 f"{tuple(own[dst].shape)}")
            own[dst].copy_(t)
    return len(take)


def vit_config(model_type: str):
    """(dim, heads, patch) of a DINO model type: vits8 (384, 6, 8), vitb8
    (768, 12, 8), vits16, vitb16."""
    dim, heads = (384, 6) if "vits" in model_type else (768, 12)
    return dim, heads, 8 if model_type.endswith("8") else 16


class ViTExtractor:
    """Dense per-layer feature maps from images, frozen: the ViT of
    `model_type` (`vit_config`), its pos-embed grid 224 / patch."""

    def __init__(self, model_type: str = "vits8", stride: int = 8, weights_path: Optional[str] = None,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        dim, heads, patch = vit_config(model_type)
        vit = ViT(dim=dim, heads=heads, patch=patch, stride=stride, pos_grid=224 // patch, seed=seed)
        if weights_path:
            load_dino_weights(vit, weights_path)
        self.vit = vit.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def extract(self, images: torch.Tensor, layers: Sequence[int] = (11,), facet: str = "key") -> List[torch.Tensor]:
        """(B, H, W, 3) -> a list of (B, gh, gw, D) maps (facet 'attn': of
        (B, heads, T, T) weights), fp32."""
        return self.vit(images.float(), harvest_layers=tuple(layers), facet=facet)

    def extract_descriptors(self, images: torch.Tensor, layer: int = 11, facet: str = "key", log_bin: bool = False,
                            hierarchy: int = 2) -> torch.Tensor:
        """(B, gh, gw, D'): the layer's map, or with `log_bin` the reference's
        log-binned descriptor: per level k < hierarchy the map average-pooled
        over a 3^k window (padding not counted) and sampled at the 8
        neighbours 3^k away (and the centre at k = 0), clamped at the
        borders, concatenated along channels: D' = D (1 + 8 hierarchy)."""
        x = self.extract(images, layers=(layer,), facet=facet)[0]
        if not log_bin:
            return x
        b, gh, gw, d = x.shape
        planes = []
        for k in range(hierarchy):
            win = 3 ** k
            pooled = x if win == 1 else F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1, padding=win // 2,
                                                     count_include_pad=False).permute(0, 2, 3, 1)
            for di in (-win, 0, win):
                for dj in (-win, 0, win):
                    if di == 0 and dj == 0 and k != 0:
                        continue  # the centre bin once, at the finest level
                    iy = (torch.arange(gh, device=x.device) + di).clamp(0, gh - 1)
                    ix = (torch.arange(gw, device=x.device) + dj).clamp(0, gw - 1)
                    planes.append(pooled[:, iy][:, :, ix])
        return torch.cat(planes, dim=-1)

    def extract_saliency_maps(self, images: torch.Tensor, head_idxs: Sequence[int] = (0, 2, 4, 5)) -> torch.Tensor:
        """(B, gh, gw) saliency in [0, 1]: the last layer's cls -> patch
        attention averaged over `head_idxs` (those the model has), min-max
        normalised per image."""
        att = self.extract(images, layers=(self.vit.depth - 1,), facet="attn")[0]
        heads = [h for h in head_idxs if h < att.shape[1]] or list(range(att.shape[1]))
        cls_attn = att[:, heads, 0, 1:].mean(dim=1)
        lo = cls_attn.min(dim=1, keepdim=True).values
        hi = cls_attn.max(dim=1, keepdim=True).values
        sal = (cls_attn - lo) / (hi - lo).clamp_min(1e-12)
        return sal.reshape(sal.shape[0], *self.vit.grid(images.shape[1], images.shape[2]))
