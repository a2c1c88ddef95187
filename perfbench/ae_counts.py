"""Operations and bytes of the KL autoencoders' calls, counted from shapes.

`encode_flops` and `decode_flops` count what
`torch.utils.flop_counter.FlopCounterMode` counts on the plain reference
(`reference/vae.py`): 2 x multiply-adds of every convolution (1x1 ones
included), linear map and attention matmul; norms, activations, padding and
resampling are not counted.  `encode_bytes` and `decode_bytes` are the
fewest bytes a layer-by-layer fp32 program moves: each convolution's and
linear map's input read once, output written once and weights read once, and
each attention's q, k and v read and output written once.  An AE call's
roofline time is the larger of its FLOPs over the fp32 peak and its bytes
over HBM's (`counts.PEAK_FP32_FLOPS`, `counts.PEAK_HBM_BYTES`): the AEs
compute in fp32, off the tensor cores.

A section is an AE's part of the configuration: `embed_dim` and the
reference's `ddconfig` keys (`ch`, `ch_mult`, `num_res_blocks`,
`attn_resolutions`, `z_channels`, `in_channels`, `out_ch`, `resolution`).
"""

from __future__ import annotations

from typing import List, Tuple

from .counts import PEAK_FP32_FLOPS, PEAK_HBM_BYTES, flash_eligible

__all__ = ["encode_flops", "decode_flops", "encode_bytes", "decode_bytes", "ae_call_roofline_s",
           "attention_sites", "plain_attention_sites"]

FP32 = 4


def _layers(section: dict, size: int, which: str) -> Tuple[list, list]:
    """([(cin, cout, k, input pixels, output pixels)] of every convolution,
    [(tokens, C)] of every attention) of one image's encode or decode at
    `size` x `size` pixels, in the order the reference runs them."""
    dd = section["ddconfig"]
    ch, mult, nrb, z, e = dd["ch"], dd["ch_mult"], dd["num_res_blocks"], dd["z_channels"], section["embed_dim"]
    attn_res = dd["attn_resolutions"]
    convs, attns = [], []

    def res(cin, cout, s):
        n = s * s
        convs.extend([(cin, cout, 3, n, n), (cout, cout, 3, n, n)] + ([(cin, cout, 1, n, n)] if cin != cout else []))

    levels = len(mult)
    if which == "encode":
        s, r = size, dd["resolution"]
        cur = ch
        convs.append((dd["in_channels"], ch, 3, s * s, s * s))
        for level, m in enumerate(mult):
            for _ in range(nrb):
                res(cur, ch * m, s)
                cur = ch * m
                if r in attn_res:
                    attns.append((s * s, cur))
            if level != levels - 1:  # the stride-2 conv reads the padded (s + 1)^2 input
                convs.append((cur, cur, 3, (s + 1) ** 2, (s // 2) ** 2))
                s, r = s // 2, r // 2
        res(cur, cur, s)
        attns.append((s * s, cur))
        res(cur, cur, s)
        convs += [(cur, 2 * z, 3, s * s, s * s), (2 * z, 2 * e, 1, s * s, s * s)]
        return convs, attns
    s, r = size // 2 ** (levels - 1), dd["resolution"] // 2 ** (levels - 1)
    cur = ch * mult[-1]
    convs += [(e, z, 1, s * s, s * s), (z, cur, 3, s * s, s * s)]
    res(cur, cur, s)
    attns.append((s * s, cur))
    res(cur, cur, s)
    for level in reversed(range(levels)):
        for _ in range(nrb + 1):
            res(cur, ch * mult[level], s)
            cur = ch * mult[level]
            if r in attn_res:
                attns.append((s * s, cur))
        if level:
            s, r = 2 * s, 2 * r
            convs.append((cur, cur, 3, s * s, s * s))  # over the upsampled input
    convs.append((cur, dd["out_ch"], 3, s * s, s * s))
    return convs, attns


def _flops(section: dict, batch: int, size: int, which: str) -> int:
    convs, attns = _layers(section, size, which)
    f = sum(2 * cin * cout * k * k * n for cin, cout, k, _, n in convs)
    f += sum(2 * t * c * 3 * c + 4 * t * t * c + 2 * t * c * c for t, c in attns)
    return batch * f


def _bytes(section: dict, batch: int, size: int, which: str) -> int:
    convs, attns = _layers(section, size, which)
    b = sum(batch * (cin * n_in + cout * n_out) + cin * cout * k * k for cin, cout, k, n_in, n_out in convs)
    # qkv: x in, q k v out; the attention: q k v in, its output out; proj_out: in and out; the two weights
    b += sum(batch * 10 * t * c + 4 * c * c for t, c in attns)
    return FP32 * b


def encode_flops(section: dict, batch: int, size: int) -> int:
    """FLOPs of one encode of (batch, size, size, in_channels)."""
    return _flops(section, batch, size, "encode")


def decode_flops(section: dict, batch: int, size: int) -> int:
    """FLOPs of one decode to (batch, size, size, out_ch)."""
    return _flops(section, batch, size, "decode")


def encode_bytes(section: dict, batch: int, size: int) -> int:
    return _bytes(section, batch, size, "encode")


def decode_bytes(section: dict, batch: int, size: int) -> int:
    return _bytes(section, batch, size, "decode")


def ae_call_roofline_s(flops: int, nbytes: int) -> float:
    """The least time an fp32 AE call of `flops` and `nbytes` can take."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def attention_sites(section: dict, size: int, which: str) -> List[Tuple[int, int]]:
    """(tokens, channels) of each one-head attention of an encode or decode."""
    return _layers(section, size, which)[1]


def plain_attention_sites(section: dict, size: int, which: str, min_tokens: int = 512) -> int:
    """How many of them the program sends to its plain attention path (one
    head of width C: the flash rule, frozen in `counts.flash_eligible`,
    admits no head wider than 256)."""
    return sum(1 for t, c in attention_sites(section, size, which)
               if not (t >= min_tokens and flash_eligible(t, t, c)))
