"""Traffic kind `slices`: stage-2 CT volumes streamed slice by slice.

The window drives `SliceLDM.stream_volume` as `cli/sample.py`'s two-stage
route does: a batch of `batch` volumes, each slice the DDIM chain of
`ddim_steps` nodes (eta `ddim_eta`) conditioned on [previous slice | mask
slice], min-max normalised into the next slice's condition, the first from
zeros.  The masks are seeded label volumes of `mask_shape` handed off to the
CT grid `volume_shape` by the program's `upsample_labels` and
`normalize_mask_channel`.  One unit is one slice of the batch (`batch` CT
slices); a new batch of volumes starts when one ends.

The comparison, after the window: a sample of the finished slices, drawn
from the seed with the first slice always in it, each recomputed by the plain
reference in fp32 from the program's previous slice (as a served model's
tokens are scored from its own prefix), the replayed x_T and the reference's
own hand-off of the same labels.  `slice_rms` is the largest RMS gap between
the program's slice and the reference's, in units of the [0, 1] range, and
`slice_max_abs` the largest gap at one pixel; `handoff_max_abs` is the
largest gap of the program's mask channel from the reference's (exact: 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.counts import unet_forward_flops
from perfbench import program
from perfbench.labels import label_volumes
from perfbench.reference import diffusion as rd
from perfbench.reference.draws import Replay
from perfbench.reference.quant import Fp8
from perfbench.reference.unet import unet_forward
from perfbench.weights import make_weights


def setup(run) -> None:
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.diffusion.ddim import DDIMParams
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    cfg, p = run.config, run.workload
    configure_precision()
    ldm = program.slice_ldm(cfg, run.device)
    shapes = program.load_seeded(ldm.unet, run.seed_of("weights"), run.device)
    ddim = DDIMParams.create(ldm.diffusion, p["ddim_steps"], "uniform", p["ddim_eta"])
    b, hw = p["batch"], (p["slice_size"], p["slice_size"])
    run.state.update(ldm=ldm, ddim=ddim, shapes=shapes, volume=-1, z=0, stream=None, slices=[], masks={},
                     labels={0: label_volumes(run.seed_of("labels", 0), b, p["mask_shape"], p["num_classes"],
                                              run.device)})
    run.flops_per_work = p["ddim_steps"] * unet_forward_flops(
        cfg, 1, hw, cfg["image_channels"] + cfg["cond_channels"], cfg["image_channels"])
    run.unet_shape = (b, hw)
    run.state["hooks"] = run.spans.hook(ldm.unet, "unet")
    with torch.inference_mode():  # the cell's shapes: two DDIM nodes of one slice and its normalisation
        warm = DDIMParams.create(ldm.diffusion, 2, "uniform", p["ddim_eta"])
        mask = _mask_channel(run, run.state["labels"][0])
        noise = NoiseSource(run.seed_of("warm-up"), run.device)
        next(ldm.stream_volume(noise, mask[:, :1], warm))
    run.spans.times.clear()


def _mask_channel(run, labels: torch.Tensor) -> torch.Tensor:
    from jointimagegeneration_torch.pipeline.two_stage import normalize_mask_channel, upsample_labels

    p = run.workload
    shape = (p["depth"], p["slice_size"], p["slice_size"])
    return normalize_mask_channel(upsample_labels(labels, shape), p["num_classes"])


def window_context(run):
    return torch.inference_mode()


def _next_slice(run) -> torch.Tensor:
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    st, p = run.state, run.workload
    if st["stream"] is not None:
        s = next(st["stream"], None)
        if s is not None:
            st["z"] += 1
            return s
    v = st["volume"] = st["volume"] + 1
    if v not in st["labels"]:
        st["labels"][v] = label_volumes(run.seed_of("labels", v), p["batch"], p["mask_shape"], p["num_classes"],
                                        run.device)
    st["masks"][v] = _mask_channel(run, st["labels"][v])
    noise = NoiseSource(run.seed_of("noise", v), run.device)
    st["stream"] = st["ldm"].stream_volume(noise, st["masks"][v], st["ddim"])
    st["z"] = 0
    return next(st["stream"])


def step(run) -> int:
    with run.spans.span("slice"):
        s = _next_slice(run)
    st = run.state
    st["slices"].append((st["volume"], st["z"], s))
    return run.workload["batch"]


def traced(run) -> int:
    """One more slice under the profiler."""
    return step(run)


def release(run) -> None:
    for h in run.state.pop("hooks"):
        h.remove()
    del run.state["ldm"], run.state["stream"]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def sample(run) -> list:
    """The slices to compare: the first, and `check_slices` - 1 more drawn
    from the seed among the rest."""
    done = run.state["slices"]
    rng = np.random.default_rng(run.seed_of("check") % 2**32)
    rest = rng.choice(np.arange(1, len(done)), size=min(len(done) - 1, run.workload["check_slices"] - 1),
                      replace=False) if len(done) > 1 else []
    return [0] + sorted(int(i) for i in rest)


def _reference_slice(run, weights, v: int, z: int, prev: torch.Tensor, ops=None) -> torch.Tensor:
    """The plain DDIM chain of slice z of volume v from `prev` (the program's
    slice z - 1, or zeros), min-max normalised."""
    cfg, p = run.config, run.workload
    replay = Replay(run.seed_of("noise", v), run.device)
    shape = (p["batch"], p["slice_size"], p["slice_size"], cfg["image_channels"])
    for _ in range(z + 1):
        x = replay.normal(shape)
    up = rd.upsample_nearest(run.state["labels"][v], (p["depth"], p["slice_size"], p["slice_size"]))
    mask = up[:, z, ..., None].float() / (p["num_classes"] - 1)
    cond = torch.cat([prev, mask], dim=-1)
    ac = rd.ldm_alphas_cumprod(cfg["timesteps"], cfg["linear_start"], cfg["linear_end"])
    ts, a, a_prev = rd.ddim_schedule(ac, p["ddim_steps"])
    for i in reversed(range(len(ts))):
        t = torch.full((shape[0],), float(ts[i]), device=run.device)
        eps = unet_forward(weights, cfg, x, t, cond, ops=ops)
        x = rd.ddim_update(x, eps, float(a[i]), float(a_prev[i]))
    return rd.minmax(x)


def readings(run, control: bool = False) -> dict:
    """{name: number} of the comparison; with `control`, the fp8 reference
    in the program's place, on the same sampled slices and conditions."""
    st, p = run.state, run.workload
    weights = make_weights(st["shapes"], run.seed_of("weights"), run.device)
    done = st["slices"]
    gaps = []
    with torch.no_grad():
        for i in sample(run):
            v, z, s = done[i]
            prev = done[i - 1][2] if z > 0 else torch.zeros_like(s)
            ref = _reference_slice(run, weights, v, z, prev)
            got = _reference_slice(run, weights, v, z, prev, ops=Fp8()) if control else s
            gaps.append((float(torch.sqrt(torch.mean((got.float() - ref) ** 2))), float((got.float() - ref).abs().max())))
        handoff = 0.0
        for v, mask in st["masks"].items():
            up = rd.upsample_nearest(st["labels"][v], (p["depth"], p["slice_size"], p["slice_size"]))
            handoff = max(handoff, float((mask[..., 0] - up.float() / (p["num_classes"] - 1)).abs().max()))
    return {"slice_rms": max((g[0] for g in gaps), default=math.inf),
            "slice_max_abs": max((g[1] for g in gaps), default=math.inf), "handoff_max_abs": handoff}

