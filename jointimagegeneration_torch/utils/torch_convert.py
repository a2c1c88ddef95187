"""Convert the reference's guided-diffusion UNet and AutoencoderKL checkpoints.

The port's own copy of `jointimagegeneration_tpu/utils/torch_convert.py`
(numpy only).  The reference's two UNets — ccdm `unet_openai/unet.py:402-823`
and LDM `ldm/modules/diffusionmodules/openaimodel.py:416-964` — share the
OpenAI guided-diffusion module layout (`time_embed.*`, `input_blocks.N.j.*`,
`middle_block.j.*`, `output_blocks.N.j.*`, `out.*`).  This module walks that
layout structurally (the level / block iteration the torch constructor
performs) and emits the JAX package's flax parameter tree of its UNet; the
port's names come from that tree through the one weight bridge,
`utils/jax_weights.unet_state_dict_from_jax` (`unet_state_dict_from_reference`),
so there is one mapping onto the port's modules, not two.

Layout translations performed:
  * conv kernels OI(D)HW -> (D)HWIO; linears (out,in) -> (in,out)
  * attention qkv/proj conv1d (C',C,1) -> Dense kernels (C,C'); the
    reference's default LEGACY head order (`QKVAttentionLegacy`,
    unet.py:334-364: 3C channels grouped [head: q|k|v]) is permuted into
    the UNet's layout ([q|k|v] each head-major) — pass
    use_new_attention_order=True for checkpoints trained with `QKVAttention`
    (already [q|k|v]-major)
  * GroupNorm weight/bias -> scale/bias (incl. the nested GroupNorm_0
    naming of GroupNorm32 sites)
  * label_emb.weight -> label_emb/embedding (adm class conditioning)

Scope: plain ResBlocks (with or without use_scale_shift_norm), AttentionBlock
self-attention, conv Up/Downsample.  `resblock_updown=True` and
SpatialTransformer checkpoints are rejected with the offending keys listed
(the shipped reference configs use neither).  The AutoencoderKL / VQModel
trunk (`convert_ldm_autoencoder`) goes to the JAX AE tree and through
`ae_state_dict_from_jax` (`ae_state_dict_from_reference`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["convert_guided_diffusion_unet", "convert_ldm_autoencoder", "find_unet_prefix",
           "unet_state_dict_from_reference", "ae_state_dict_from_reference"]


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):  # a torch tensor, fp16 / bf16 ones included
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch conv OI(D)HW -> flax (D)HWIO."""
    spatial = tuple(range(2, w.ndim))
    return np.transpose(w, spatial + (1, 0))


def _legacy_qkv_perm(c: int, heads: int) -> np.ndarray:
    """Column permutation taking the LEGACY torch qkv output layout
    ([h0: q d | k d | v d][h1: ...]) to ours ([q: h0 d, h1 d, ...][k][v])."""
    d = c // heads
    perm = np.empty(3 * c, np.int64)
    for block in range(3):  # q, k, v
        for h in range(heads):
            ours = block * c + h * d
            theirs = h * 3 * d + block * d
            perm[ours: ours + d] = np.arange(theirs, theirs + d)
    return perm


def find_unet_prefix(sd: Dict[str, "np.ndarray"]) -> str:
    """Locate the UNet inside a larger checkpoint: '' for a bare UNet
    state_dict (the ccdm `average_model` entry, trainer.py:452), 'unet.'
    for the DenoisingModel entry, 'model.diffusion_model.' for an LDM
    Lightning checkpoint."""
    marker = "input_blocks.0.0.weight"
    for k in sd:
        if k.endswith(marker):
            return k[: -len(marker)]
    raise KeyError(f"no guided-diffusion UNet found (no key ends with {marker!r})")


class _Reader:
    def __init__(self, sd: Dict[str, np.ndarray], prefix: str):
        self.sd, self.prefix = sd, prefix
        self.used: set = set()

    def __call__(self, name: str) -> np.ndarray:
        k = self.prefix + name
        self.used.add(k)
        return _np(self.sd[k])

    def has(self, name: str) -> bool:
        return self.prefix + name in self.sd

    def unconsumed(self) -> List[str]:
        return sorted(k for k in self.sd if k.startswith(self.prefix) and k not in self.used)


def _res_params(r: _Reader, at: str) -> dict:
    p = {
        "norm1_scale": r(f"{at}.in_layers.0.weight"),
        "norm1_bias": r(f"{at}.in_layers.0.bias"),
        "conv1_kernel": _conv_kernel(r(f"{at}.in_layers.2.weight")),
        "conv1_bias": r(f"{at}.in_layers.2.bias"),
        "emb_kernel": r(f"{at}.emb_layers.1.weight").T,
        "emb_bias": r(f"{at}.emb_layers.1.bias"),
        "norm2_scale": r(f"{at}.out_layers.0.weight"),
        "norm2_bias": r(f"{at}.out_layers.0.bias"),
        "conv2_kernel": _conv_kernel(r(f"{at}.out_layers.3.weight")),
        "conv2_bias": r(f"{at}.out_layers.3.bias"),
    }
    if r.has(f"{at}.skip_connection.weight"):
        p["skip_kernel"] = _conv_kernel(r(f"{at}.skip_connection.weight"))
        p["skip_bias"] = r(f"{at}.skip_connection.bias")
    return p


def _attn_params(r: _Reader, at: str, heads: int, new_order: bool) -> dict:
    qkv_w = r(f"{at}.qkv.weight")[..., 0]  # (3C, C)
    qkv_b = r(f"{at}.qkv.bias")
    c = qkv_w.shape[1]
    if not new_order:
        perm = _legacy_qkv_perm(c, heads)
        qkv_w, qkv_b = qkv_w[perm], qkv_b[perm]
    return {
        "norm": {"GroupNorm_0": {"scale": r(f"{at}.norm.weight"),
                                 "bias": r(f"{at}.norm.bias")}},
        "qkv": {"kernel": qkv_w.T, "bias": qkv_b},
        "proj_out": {"kernel": r(f"{at}.proj_out.weight")[..., 0].T,
                     "bias": r(f"{at}.proj_out.bias")},
    }


def convert_guided_diffusion_unet(
    sd: Dict[str, "np.ndarray"],
    *,
    model_channels: int,
    channel_mult: Sequence[int],
    num_res_blocks: int,
    attention_resolutions: Iterable[int] = (),
    num_head_channels: int = -1,
    num_heads: int = 1,
    use_new_attention_order: bool = False,
    prefix: Optional[str] = None,
    strict: bool = True,
) -> dict:
    """torch guided-diffusion UNet state_dict -> the JAX package's UNet params
    (the `{'params': ...}` inner dict).  Config args must match the
    checkpoint's architecture (`attention_resolutions` in the in-model
    `ds` convention, as both constructors consume it)."""
    attn_ds = set(attention_resolutions)
    if prefix is None:
        prefix = find_unet_prefix(sd)
    r = _Reader(sd, prefix)

    def heads_for(ch: int) -> int:
        # max(1, …) clamp matches nn/blocks.py AttentionBlock (a site
        # narrower than num_head_channels runs single-headed)
        return num_heads if num_head_channels == -1 else max(1, ch // num_head_channels)

    out: dict = {
        "time_embed_0": {"kernel": r("time_embed.0.weight").T, "bias": r("time_embed.0.bias")},
        "time_embed_1": {"kernel": r("time_embed.2.weight").T, "bias": r("time_embed.2.bias")},
        "in_conv": {"kernel": _conv_kernel(r("input_blocks.0.0.weight")),
                    "bias": r("input_blocks.0.0.bias")},
        "out_norm": {"GroupNorm_0": {"scale": r("out.0.weight"), "bias": r("out.0.bias")}},
        "out_conv": {"kernel": _conv_kernel(r("out.2.weight")), "bias": r("out.2.bias")},
    }
    if r.has("label_emb.weight"):
        out["label_emb"] = {"embedding": r("label_emb.weight")}

    # -- encoder: mirror the torch constructor's entry/ds bookkeeping ----
    entry, ds = 1, 1
    ch = model_channels * channel_mult[0]
    for level, mult in enumerate(channel_mult):
        for i in range(num_res_blocks):
            ch = model_channels * mult
            out[f"down_{level}_{i}_res"] = _res_params(r, f"input_blocks.{entry}.0")
            if ds in attn_ds:
                out[f"down_{level}_{i}_attn"] = _attn_params(
                    r, f"input_blocks.{entry}.1", heads_for(ch), use_new_attention_order)
            entry += 1
        if level != len(channel_mult) - 1:
            out[f"down_{level}_ds"] = {"op": {
                "kernel": _conv_kernel(r(f"input_blocks.{entry}.0.op.weight")),
                "bias": r(f"input_blocks.{entry}.0.op.bias")}}
            entry += 1
            ds *= 2

    out["mid_res1"] = _res_params(r, "middle_block.0")
    out["mid_attn"] = _attn_params(r, "middle_block.1", heads_for(ch), use_new_attention_order)
    out["mid_res2"] = _res_params(r, "middle_block.2")

    # -- decoder ---------------------------------------------------------
    entry = 0
    for level in reversed(range(len(channel_mult))):
        ch = model_channels * channel_mult[level]
        for i in range(num_res_blocks + 1):
            out[f"up_{level}_{i}_res"] = _res_params(r, f"output_blocks.{entry}.0")
            j = 1
            if ds in attn_ds:
                out[f"up_{level}_{i}_attn"] = _attn_params(
                    r, f"output_blocks.{entry}.{j}", heads_for(ch), use_new_attention_order)
                j += 1
            if level and i == num_res_blocks:
                out[f"up_{level}_us"] = {"conv": {
                    "kernel": _conv_kernel(r(f"output_blocks.{entry}.{j}.conv.weight")),
                    "bias": r(f"output_blocks.{entry}.{j}.conv.bias")}}
                ds //= 2
            entry += 1

    leftover = r.unconsumed()
    if leftover and strict:
        raise ValueError(
            "unconsumed checkpoint keys (resblock_updown / SpatialTransformer "
            f"checkpoints are out of converter scope): {leftover[:8]}"
            + (f" ... +{len(leftover) - 8} more" if len(leftover) > 8 else "")
        )
    return out


def _vae_res(r: _Reader, at: str) -> dict:
    p = {
        "norm1": {"GroupNorm_0": {"scale": r(f"{at}.norm1.weight"),
                                  "bias": r(f"{at}.norm1.bias")}},
        "conv1": {"kernel": _conv_kernel(r(f"{at}.conv1.weight")),
                  "bias": r(f"{at}.conv1.bias")},
        "norm2": {"GroupNorm_0": {"scale": r(f"{at}.norm2.weight"),
                                  "bias": r(f"{at}.norm2.bias")}},
        "conv2": {"kernel": _conv_kernel(r(f"{at}.conv2.weight")),
                  "bias": r(f"{at}.conv2.bias")},
    }
    if r.has(f"{at}.nin_shortcut.weight"):
        p["nin_shortcut"] = {"kernel": _conv_kernel(r(f"{at}.nin_shortcut.weight")),
                             "bias": r(f"{at}.nin_shortcut.bias")}
    if r.has(f"{at}.conv_shortcut.weight"):
        raise ValueError(f"{at}: conv_shortcut (3x3) checkpoints are out of scope "
                         "(this VAE uses the default 1x1 nin_shortcut)")
    return p


def _vae_attn(r: _Reader, at: str) -> dict:
    """Reference AttnBlock (model.py:154-207: separate 1x1 q/k/v convs,
    single head) -> fused-qkv AttentionBlock params."""
    wq, wk, wv = (r(f"{at}.{n}.weight").reshape(
        r(f"{at}.{n}.weight").shape[:2]) for n in ("q", "k", "v"))
    bq, bk, bv = (r(f"{at}.{n}.bias") for n in ("q", "k", "v"))
    return {
        "norm": {"GroupNorm_0": {"scale": r(f"{at}.norm.weight"),
                                 "bias": r(f"{at}.norm.bias")}},
        "qkv": {"kernel": np.concatenate([wq.T, wk.T, wv.T], axis=1),
                "bias": np.concatenate([bq, bk, bv])},
        "proj_out": {"kernel": r(f"{at}.proj_out.weight").reshape(
            r(f"{at}.proj_out.weight").shape[:2]).T,
            "bias": r(f"{at}.proj_out.bias")},
    }


def _vae_trunk(r: _Reader, side: str) -> dict:
    """One Encoder/Decoder trunk.  Unlike the UNet, the reference's VAE
    key names carry explicit level/block indices (down.L.block.I /
    up.L.block.I, model.py:368-520), so the walk is key-driven."""
    import re as _re

    out = {
        "conv_in": {"kernel": _conv_kernel(r(f"{side}.conv_in.weight")),
                    "bias": r(f"{side}.conv_in.bias")},
        "mid_1": _vae_res(r, f"{side}.mid.block_1"),
        "mid_attn": _vae_attn(r, f"{side}.mid.attn_1"),
        "mid_2": _vae_res(r, f"{side}.mid.block_2"),
        "norm_out": {"GroupNorm_0": {"scale": r(f"{side}.norm_out.weight"),
                                     "bias": r(f"{side}.norm_out.bias")}},
        "conv_out": {"kernel": _conv_kernel(r(f"{side}.conv_out.weight")),
                     "bias": r(f"{side}.conv_out.bias")},
    }
    stage = "down" if side == "encoder" else "up"
    pat = _re.compile(_re.escape(f"{side}.{stage}.") + r"(\d+)\.(block|attn)\.(\d+)\.norm1?\.weight$")
    for k in list(r.sd):
        m = pat.search(k)
        if not m:
            continue
        level, kind, i = int(m.group(1)), m.group(2), int(m.group(3))
        if kind == "block":
            out[f"{stage}_{level}_{i}"] = _vae_res(r, f"{side}.{stage}.{level}.block.{i}")
        else:
            out[f"{stage}_{level}_{i}_attn"] = _vae_attn(r, f"{side}.{stage}.{level}.attn.{i}")
    for k in list(r.sd):
        m = _re.search(_re.escape(f"{side}.{stage}.") + r"(\d+)\.(downsample|upsample)\.conv\.weight$", k)
        if m:
            level = int(m.group(1))
            at = f"{side}.{stage}.{level}.{m.group(2)}"
            out[f"{stage}_{level}_ds" if stage == "down" else f"{stage}_{level}_us"] = {
                "kernel": _conv_kernel(r(f"{at}.conv.weight")),
                "bias": r(f"{at}.conv.bias")}
    return out


def convert_ldm_autoencoder(sd: Dict[str, "np.ndarray"], prefix: Optional[str] = None,
                            strict: bool = True) -> dict:
    """Reference AutoencoderKL/VQModel state_dict (autoencoder.py:18-482 +
    model.py Encoder/Decoder) -> the JAX package's AE param tree
    ({'encoder', 'decoder', 'quant_conv', 'post_quant_conv'}).

    With an LDM LatentDiffusion checkpoint, pass
    prefix='first_stage_model.' (or 'cond_stage_model.'); a standalone AE
    training checkpoint auto-detects — ambiguous checkpoints (more than
    one embedded AE) REFUSE to guess.  A VQModel checkpoint (detected by
    `quantize.embedding.weight`) additionally maps the codebook to
    `quantize.codebook`.  `loss.*` keys (LPIPS + discriminators) are
    skipped — inference needs none of them."""
    if prefix is None:
        marker = "encoder.conv_in.weight"
        cands = [k[: -len(marker)] for k in sd if k.endswith(marker)]
        if not cands:
            raise KeyError(f"no AutoencoderKL found (no key ends with {marker!r})")
        if len(cands) > 1:
            raise ValueError(
                f"checkpoint embeds {len(cands)} AEs ({sorted(cands)}); pass the "
                "prefix explicitly (e.g. --ae first_stage_model.)")
        prefix = cands[0]
    r = _Reader(sd, prefix)
    out = {
        "encoder": _vae_trunk(r, "encoder"),
        "decoder": _vae_trunk(r, "decoder"),
        "quant_conv": {"kernel": _conv_kernel(r("quant_conv.weight")),
                       "bias": r("quant_conv.bias")},
        "post_quant_conv": {"kernel": _conv_kernel(r("post_quant_conv.weight")),
                            "bias": r("post_quant_conv.bias")},
    }
    if r.has("quantize.embedding.weight"):
        # taming VectorQuantizer codebook -> the VQ model's codebook
        out["quantize"] = {"codebook": r("quantize.embedding.weight")}
    leftover = [k for k in r.unconsumed() if ".loss." not in k and not k.startswith(f"{prefix}loss.")]
    if leftover and strict:
        raise ValueError(f"unconsumed AE keys: {leftover[:8]}"
                         + (f" ... +{len(leftover) - 8} more" if len(leftover) > 8 else ""))
    return out


def unet_state_dict_from_reference(sd: Dict[str, "np.ndarray"], **kwargs) -> Dict[str, "torch.Tensor"]:
    """The port UNet's state dict (fp32 CPU tensors) from a reference UNet
    state dict: `convert_guided_diffusion_unet(sd, **kwargs)` through the
    weight bridge."""
    from .jax_weights import unet_state_dict_from_jax

    return unet_state_dict_from_jax(convert_guided_diffusion_unet(sd, **kwargs))


def ae_state_dict_from_reference(sd: Dict[str, "np.ndarray"], prefix: Optional[str] = None,
                                 strict: bool = True) -> Dict[str, "torch.Tensor"]:
    """The port AE's state dict (`models.autoencoder.AutoencoderKL` /
    `VQModel`) from a reference AE state dict: `convert_ldm_autoencoder`
    through the weight bridge."""
    from .jax_weights import ae_state_dict_from_jax

    return ae_state_dict_from_jax(convert_ldm_autoencoder(sd, prefix=prefix, strict=strict))
