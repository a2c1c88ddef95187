"""Operations and bytes, counted from shapes, and the card's published peaks.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, without
sparsity), as `chip_smoke.py` states them: 989 TFLOP/s
in bf16 on the tensor cores, 67 TFLOP/s in fp32 off them (the fp32 flash
kernels' FMA path), 3.35 TB/s of HBM3.  A kernel's roofline time is the
larger of its operations over its peak and its bytes over HBM's.

`unet_forward_flops` counts what `torch.utils.flop_counter.FlopCounterMode`
counts on the plain reference: 2 x multiply-adds of every convolution, linear
map and attention matmul (norms, activations and resampling are not counted).
A training step counts 3 x the forward (forward, and the backward's two
products per layer).  With a text context of L tokens of width E, each
attention site is a transformer block (`reference.unet`) and the text refiner
runs once per sampled volume (`refiner_flops`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from .reference.unet import attention_sites

__all__ = ["PEAK_BF16_FLOPS", "PEAK_FP32_FLOPS", "PEAK_HBM_BYTES", "unet_forward_flops", "refiner_flops",
           "flash_sites", "refiner_flash_sites", "flash_fwd_roofline_s", "flash_bwd_roofline_s", "flash_eligible"]

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
FP32 = 4


def _block_flops(tokens: int, width: int, inner: int, context=None) -> int:
    """One transformer block over `tokens` x `width`: q, k, v and out of
    both attention layers (the second over `context` = (L, E) where given),
    their two products each, and the GEGLU feed-forward (width -> 8 width,
    4 width -> width)."""
    lc, ec = context or (tokens, width)
    attn1 = 2 * tokens * width * inner * 4 + 4 * tokens * tokens * inner
    attn2 = 2 * tokens * width * inner * 2 + 2 * lc * ec * inner * 2 + 4 * tokens * lc * inner
    return attn1 + attn2 + 24 * tokens * width * width


def refiner_flops(enc: dict, batch: int, tokens: int) -> int:
    """FLOPs of one text refiner call over (batch, tokens, embed_dim)."""
    e, inner = enc["embed_dim"], enc["n_heads"] * enc["d_head"]
    return batch * enc["model_depth"] * _block_flops(tokens, e, inner)


def unet_forward_flops(cfg: dict, batch: int, spatial: Sequence[int], in_ch: int, out_ch: int,
                       context: Optional[Tuple[int, int]] = None) -> int:
    """FLOPs of one UNet forward at `batch` x `spatial`, `in_ch` input
    channels (the condition included), with a text context of (L tokens,
    width E) where given."""
    dims = len(spatial)
    k3 = 3 ** dims
    mc, mult, nrb = cfg["model_channels"], cfg["channel_mult"], cfg["num_res_blocks"]
    emb = 4 * mc
    vox = lambda size: batch * math.prod(size)
    conv = lambda cin, cout, size, k=k3: 2 * cin * cout * k * vox(size)

    def res(cin, cout, size):
        f = conv(cin, cout, size) + conv(cout, cout, size) + 2 * batch * emb * cout
        return f + (conv(cin, cout, size, 1) if cin != cout else 0)

    flops = 2 * batch * (mc * emb + emb * emb)  # the time MLP
    size = list(spatial)
    ch = mc * mult[0]
    flops += conv(in_ch, ch, size)
    skips, sizes = [ch], []
    for level, m in enumerate(mult):
        for _ in range(nrb):
            flops += res(ch, m * mc, size)
            ch = m * mc
            skips.append(ch)
        if level != len(mult) - 1:
            size = [(s + 1) // 2 for s in size]
            flops += conv(ch, ch, size)
            skips.append(ch)
    flops += 2 * res(ch, ch, size)
    for level in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            flops += res(ch + skips.pop(), mult[level] * mc, size)
            ch = mult[level] * mc
        if level:
            size = [s * 2 for s in size]
            flops += conv(ch, ch, size)
    flops += conv(ch, out_ch, size)
    for tokens, c in attention_sites(cfg, spatial):
        if context is None:
            flops += batch * (2 * tokens * c * 3 * c + 2 * tokens * c * c + 4 * tokens * tokens * c)
        else:  # proj_in, the block, proj_out
            flops += batch * (4 * tokens * c * c + _block_flops(tokens, c, c, context))
    return flops


def flash_eligible(tq: int, tk: int, d: int) -> bool:
    """The program's shape rule for its flash kernels, frozen: blocks halve
    from 1024 while they do not divide T and are >= 128; the kernel is taken
    where the blocks divide Tq and Tk and D <= 256."""
    def block(t):
        b = min(1024, t)
        while b >= 128 and t % b:
            b //= 2
        return b
    return not (tq % block(tq) or tk % block(tk) or d > 256)


def flash_sites(cfg: dict, batch: int, spatial: Sequence[int], context_tokens: Optional[int] = None,
                min_tokens: int = 512) -> list:
    """(BH, Tq, Tk, D) of every attention of one UNet forward that the
    program sends to its flash kernels (Tq >= 512 and the shape rule): each
    site's self-attention, and with a context of `context_tokens` its
    cross-attention."""
    d = cfg["num_head_channels"]
    sites = []
    for t, c in attention_sites(cfg, spatial):
        keys = [t] if context_tokens is None else [t, context_tokens]
        sites += [(batch * (c // d), t, k, d) for k in keys if t >= min_tokens and flash_eligible(t, k, d)]
    return sites


def refiner_flash_sites(enc: dict, batch: int, tokens: int, min_tokens: int = 512) -> list:
    """(BH, T, T, D) of the text refiner's self-attentions (two a block)
    that reach the flash kernels; in fp32, as the refiner runs."""
    bh, d = batch * enc["n_heads"], enc["d_head"]
    ok = tokens >= min_tokens and flash_eligible(tokens, tokens, d)
    return [(bh, tokens, tokens, d)] * (2 * enc["model_depth"]) if ok else []


def flash_fwd_roofline_s(bh: int, tq: int, tk: int, d: int, fp32: bool = False) -> float:
    """S = QK^T and O = PV (4 BH Tq Tk D); Q, K, V read and O written in bf16
    (fp32 with `fp32`, at the fp32 peak), the fp32 LSE written."""
    flops = 4 * bh * tq * tk * d
    nbytes = (FP32 if fp32 else BF16) * d * bh * (2 * tq + 2 * tk) + 4 * bh * tq
    return max(flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS), nbytes / PEAK_HBM_BYTES)


def flash_bwd_roofline_s(bh: int, tq: int, tk: int, d: int) -> float:
    """S recomputed, dP, dV, dQ and dK (10 BH Tq Tk D); Q, K, V, O, dO read and
    dQ, dK, dV written in bf16, the fp32 LSE read."""
    flops = 10 * bh * tq * tk * d
    nbytes = BF16 * d * bh * (3 * tq + 2 * tk) + BF16 * d * bh * (tq + 2 * tk) + 4 * bh * tq
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
