"""What the autoencoder layer's metrics read (`layer_metrics/ae_card_ms.py`,
`layer_metrics/ae_roofline.py`): the program's `ae.encode` and `ae.decode`
card spans in the profiled segment of a `--trace 1` run (the program's span
recorder, `core/logging.py`), and the counters the traffic module read
around the segment's units (`drivers/latent_slices.traced`).

A program without those spans or counters, or a run without a profiled
segment, gives None: the harness then leaves the metric out.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from . import ae_counts
from .counts import attention_sites, flash_sites

__all__ = ["ae_spans", "ae_card_ms", "ae_roofline", "expected_counts"]

NAMES = ("ae.encode", "ae.decode")


def ae_spans(run) -> Optional[List[tuple]]:
    """The segment's `ae.encode` and `ae.decode` records that carry card
    times, (name, depth, host_open, host_close, card_open, card_close) in
    ns, or None."""
    if run.profile is None or not run.state.get("traced_units"):
        return None
    try:
        from jointimagegeneration_torch.core.logging import records
    except ImportError:
        return None
    spans = [r for r in records() if r[0] in NAMES and r[4] is not None]
    return spans or None


def ae_card_ms(run) -> Optional[float]:
    """Card ms of the segment's autoencoder spans, per unit."""
    spans = ae_spans(run)
    return None if spans is None else sum(r[5] - r[4] for r in spans) / 1e6 / run.state["traced_units"]


def expected_counts(run) -> dict:
    """The counters' reading that the shapes give for the segment's units:
    one cond encode and one decode a unit (no guidance), and the plain
    attention launches of `ddim_steps` UNet calls and of the two calls'
    one-head sites."""
    cfg, p, units = run.config, run.workload, run.state["traced_units"]
    batch, spatial = run.unet_shape
    unet_plain = len(attention_sites(cfg, spatial)) - len(flash_sites(cfg, batch, spatial))
    ae_plain = (ae_counts.plain_attention_sites(cfg["cond_stage"], p["slice_size"], "encode")
                + ae_counts.plain_attention_sites(cfg["first_stage"], p["slice_size"], "decode"))
    return {"ae_encode": units, "ae_decode": units, "plain_attention": units * (p["ddim_steps"] * unet_plain + ae_plain)}


def ae_roofline(run) -> Optional[float]:
    """The sum over the segment's autoencoder calls of each one's roofline
    time (its FLOPs at the fp32 peak or its bytes at HBM's rate, whichever
    is longer), over the card time of their spans; in percent.  None where
    the program's counters disagree with the calls the shapes give."""
    spans = ae_spans(run)
    if spans is None:
        return None
    counted, expected = run.state.get("traced_counts"), expected_counts(run)
    if counted != expected:
        print(f"ae_roofline: the program counted {counted}, the shapes give {expected}", file=sys.stderr)
        return None
    cfg, p = run.config, run.workload
    b, size, units = p["batch"], p["slice_size"], run.state["traced_units"]
    bound = units * (ae_counts.ae_call_roofline_s(ae_counts.encode_flops(cfg["cond_stage"], b, size),
                                                  ae_counts.encode_bytes(cfg["cond_stage"], b, size))
                     + ae_counts.ae_call_roofline_s(ae_counts.decode_flops(cfg["first_stage"], b, size),
                                                    ae_counts.decode_bytes(cfg["first_stage"], b, size)))
    card_s = sum(r[5] - r[4] for r in spans) / 1e9
    return 100.0 * bound / card_s if card_s > 0 else None
