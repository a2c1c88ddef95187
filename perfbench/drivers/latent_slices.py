"""Traffic kind `latent_slices`: stage-2 CT volumes streamed slice by slice
through the latent `_ae` route.

The program is built as `cli/sample.py` builds `stage: ct` from
`configs/sample_ct_ae.yml`: the pixel `SliceLDM` by `build_slice_ldm`, wrapped
by `cli.common.build_latent_ldm` with the first-stage and cond-stage KL
autoencoders of the configuration's `first_stage` and `cond_stage` groups,
then the benchmark's seeded weights loaded into the UNet and both
autoencoders.  The window drives `LatentSliceLDM.stream_volume`: a batch of
`batch` volumes; per slice the cond stage encodes [previous slice | mask
slice] at `slice_size`^2 to its latent (the posterior's mode), the DDIM chain
of `ddim_steps` nodes (eta `ddim_eta`, no guidance, no warm start) runs on
the first stage's latent, the first stage decodes it and the slice is min-max
normalised into the next slice's condition, the first from zeros.  The masks
are seeded label volumes of `mask_shape` handed off to the CT grid by the
program's `upsample_labels` and `normalize_mask_channel`.  One unit is one
slice of the batch (`batch` CT slices); a new batch starts when one ends.

The comparison, after the window, on a sample of the finished slices drawn
from the seed, the first always in it, in exact fp32 (`reference/vae.py`,
`reference/unet.py`, `reference/diffusion.py`), each autoencoder call one
image at a time:
  * `slice_rms`, `slice_max_abs`: each sampled slice recomputed from the
    program's previous slice (zeros for the first), the replayed x_T and the
    reference's own hand-off of the same labels: encode, the chain, decode,
    min-max; the largest RMS gap and the largest gap at one pixel, in units of
    the [0, 1] range;
  * `decode_rel_max`: the program's decode of its own final latent against
    the reference's decode of the same latent, the largest gap over max |ref|;
  * `cond_rel_max`: the program's cond encode of its own [prev | mask] pair
    against the reference's encode of the same pair, likewise;
  * `handoff_max_abs`: the program's mask channel against the reference's
    nearest hand-off / (classes - 1) (exact: 0).
What the program's autoencoders took and gave is read by forward hooks on
their modules (the decoder's `post_quant_conv` and `decoder`, the cond
encoder's `encoder` and `quant_conv`), so the window's own calls are
compared.  The control puts the fp8 reference (`reference/quant.py`) in the
program's place for each number.

The stream's bookkeeping (`_next_slice`, `sample`, the hand-off) is the
pixel traffic's (`drivers/slices.py`), copied so that each cell's files stay
its own.

A traced unit also reads the program's counters of its autoencoder calls
(`models/latent_ldm.ae_encode.launches`, `ae_decode.launches`) and of its
plain attention path (`ops/attention.plain_attention.launches`) around it,
for `ae_roofline`; a program without them reads None there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import ae_counts
from perfbench import program
from perfbench.counts import unet_forward_flops
from perfbench.labels import label_volumes
from perfbench.reference import diffusion as rd
from perfbench.reference import vae
from perfbench.reference.draws import Replay
from perfbench.reference.quant import Fp8
from perfbench.reference.unet import unet_forward
from perfbench.weights import make_weights

STAGES = ("first_stage", "cond_stage")


def stage2_section(cfg: dict, slice_size: int) -> dict:
    """The configuration as `configs/sample_ct_ae.yml`'s `stage2` section."""
    if cfg["ae_dtype"] != "float32":
        raise ValueError(f"ae_dtype {cfg['ae_dtype']!r}: the program's autoencoders compute in float32")
    unet = {k: cfg[k] for k in ("model_channels", "channel_mult", "attention_resolutions", "num_res_blocks",
                                "num_head_channels")}
    return {"slice_size": slice_size, "timesteps": cfg["timesteps"], "beta_schedule": cfg["beta_schedule"],
            "linear_start": cfg["linear_start"], "linear_end": cfg["linear_end"], "channels": cfg["image_channels"],
            "cond_channels": cfg["cond_channels"], "bf16": cfg["dtype"] == "bfloat16",
            "unet_config": {"params": unet}, "first_stage": dict(cfg["first_stage"], scale_factor=cfg["scale_factor"]),
            "cond_stage": cfg["cond_stage"]}


def counters() -> dict:
    """The program's counters of its autoencoder calls and plain attention
    launches (None where the program has no such counter)."""
    from jointimagegeneration_torch.models import latent_ldm
    from jointimagegeneration_torch.ops import attention

    fns = {"ae_encode": getattr(latent_ldm, "ae_encode", None), "ae_decode": getattr(latent_ldm, "ae_decode", None),
           "plain_attention": attention.plain_attention}
    return {name: getattr(fn, "launches", None) for name, fn in fns.items()}


def _hooks(run, latent) -> list:
    """Forward hooks that keep what the window's autoencoder calls took and
    gave: the decoded latent and the decode, the cond pair and its mode."""
    st = run.state
    fs, cs = latent.first_stage, latent.cond_stage
    embed = run.config["cond_stage"]["embed_dim"]

    def keep(key, what):
        return lambda _m, args, *out: st["ae_io"].__setitem__(key, what(args, out))

    return [fs.post_quant_conv.register_forward_pre_hook(keep("dec_z", lambda a, o: a[0])),
            fs.decoder.register_forward_hook(keep("dec_out", lambda a, o: o[0])),
            cs.encoder.register_forward_pre_hook(keep("enc_x", lambda a, o: a[0])),
            cs.quant_conv.register_forward_hook(keep("enc_mode", lambda a, o: o[0][..., :embed]))]


def setup(run) -> None:
    from jointimagegeneration_torch.cli.common import build_latent_ldm
    from jointimagegeneration_torch.cli.sample import build_slice_ldm
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.diffusion.ddim import DDIMParams
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    cfg, p = run.config, run.workload
    configure_precision()
    s2 = stage2_section(cfg, p["slice_size"])
    latent, lat = build_latent_ldm(s2, build_slice_ldm(s2, run.device), p["slice_size"], run.device)
    shapes = {"unet": program.load_seeded(latent.unet, run.seed_of("weights"), run.device)}
    for name in STAGES:
        shapes[name] = program.load_seeded(getattr(latent, name), run.seed_of("weights", name), run.device)
    ddim = DDIMParams.create(latent.diffusion, p["ddim_steps"], "uniform", p["ddim_eta"])
    b, size = p["batch"], p["slice_size"]
    run.state.update(ldm=latent, ddim=ddim, shapes=shapes, volume=-1, z=0, stream=None, slices=[], masks={},
                     ae_io={}, traced_counts=None, traced_units=0,
                     labels={0: label_volumes(run.seed_of("labels", 0), b, p["mask_shape"], p["num_classes"],
                                              run.device)})
    in_ch = cfg["image_channels"] + cfg["cond_channels"]
    run.flops_per_work = (p["ddim_steps"] * unet_forward_flops(cfg, 1, (lat, lat), in_ch, cfg["image_channels"])
                          + ae_counts.encode_flops(cfg["cond_stage"], 1, size)
                          + ae_counts.decode_flops(cfg["first_stage"], 1, size))
    run.unet_shape = (b, (lat, lat))
    run.state["hooks"] = run.spans.hook(latent.unet, "unet") + _hooks(run, latent)
    with torch.inference_mode():  # the cell's shapes: two DDIM nodes of one slice, its encode, decode and min-max
        warm = DDIMParams.create(latent.diffusion, 2, "uniform", p["ddim_eta"])
        mask = _mask_channel(run, run.state["labels"][0])
        noise = NoiseSource(run.seed_of("warm-up"), run.device)
        next(latent.stream_volume(noise, mask[:, :1], warm))
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
    st = run.state
    st["ae_io"] = {}
    with run.spans.span("slice"):
        s = _next_slice(run)
    st["slices"].append((st["volume"], st["z"], s, st["ae_io"]))
    return run.workload["batch"]


def traced(run) -> int:
    """One more slice under the profiler, with the program's counters read
    around it."""
    before = counters()
    work = step(run)
    after = counters()
    run.state["traced_counts"] = {k: None if after[k] is None else after[k] - before[k] for k in after}
    run.state["traced_units"] += 1
    return work


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


def _per_image(fn, x: torch.Tensor) -> torch.Tensor:
    """`fn` of each image of the batch in turn, stacked."""
    return torch.cat([fn(x[j:j + 1]) for j in range(x.shape[0])])


def _encode(run, weights, pair, ops=None):
    return _per_image(lambda x: vae.encode(weights["cond_stage"], run.config["cond_stage"], x, ops=ops), pair)


def _decode(run, weights, z, ops=None):
    return _per_image(lambda x: vae.decode(weights["first_stage"], run.config["first_stage"], x, ops=ops), z)


def _reference_slice(run, weights, v: int, z: int, prev: torch.Tensor, ops=None) -> torch.Tensor:
    """Slice z of volume v from `prev` (the program's slice z - 1, or zeros):
    the cond encode of [prev | mask], the plain DDIM chain on the latent from
    the replayed x_T, the decode, min-max."""
    cfg, p = run.config, run.workload
    lat = p["slice_size"] // 2 ** (len(cfg["first_stage"]["ddconfig"]["ch_mult"]) - 1)
    replay = Replay(run.seed_of("noise", v), run.device)
    shape = (p["batch"], lat, lat, cfg["image_channels"])
    for _ in range(z + 1):
        x = replay.normal(shape)
    up = rd.upsample_nearest(run.state["labels"][v], (p["depth"], p["slice_size"], p["slice_size"]))
    mask = up[:, z, ..., None].float() / (p["num_classes"] - 1)
    cond = _encode(run, weights, torch.cat([prev.float(), mask], dim=-1), ops)
    ac = rd.ldm_alphas_cumprod(cfg["timesteps"], cfg["linear_start"], cfg["linear_end"])
    ts, a, a_prev = rd.ddim_schedule(ac, p["ddim_steps"])
    for i in reversed(range(len(ts))):
        t = torch.full((shape[0],), float(ts[i]), device=run.device)
        eps = unet_forward(weights["unet"], cfg, x, t, cond, ops=ops)
        x = rd.ddim_update(x, eps, float(a[i]), float(a_prev[i]))
    return rd.minmax(_decode(run, weights, x / cfg["scale_factor"], ops))


def _rel(got, ref) -> float:
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def readings(run, control: bool = False) -> dict:
    """{name: number} of the comparison; with `control`, the fp8 reference
    in the program's place, on the same sampled slices and inputs."""
    st, p = run.state, run.workload
    weights = {"unet": make_weights(st["shapes"]["unet"], run.seed_of("weights"), run.device)}
    for name in STAGES:
        weights[name] = make_weights(st["shapes"][name], run.seed_of("weights", name), run.device)
    done = st["slices"]
    gaps, dec, enc = [], [], []
    with torch.no_grad():
        for i in sample(run):
            v, z, s, io = done[i]
            prev = done[i - 1][2] if z > 0 else torch.zeros_like(s)
            ref = _reference_slice(run, weights, v, z, prev)
            got = _reference_slice(run, weights, v, z, prev, ops=Fp8()) if control else s
            gaps.append((float(torch.sqrt(torch.mean((got.float() - ref) ** 2))), float((got.float() - ref).abs().max())))
            if "dec_z" in io and "dec_out" in io:
                ref = _decode(run, weights, io["dec_z"].float())
                got = _decode(run, weights, io["dec_z"].float(), Fp8()) if control else io["dec_out"]
                dec.append(_rel(got, ref))
            if "enc_x" in io and "enc_mode" in io:
                ref = _encode(run, weights, io["enc_x"].float())
                got = _encode(run, weights, io["enc_x"].float(), Fp8()) if control else io["enc_mode"]
                enc.append(_rel(got, ref))
        handoff = 0.0
        for v, mask in st["masks"].items():
            up = rd.upsample_nearest(st["labels"][v], (p["depth"], p["slice_size"], p["slice_size"]))
            handoff = max(handoff, float((mask[..., 0] - up.float() / (p["num_classes"] - 1)).abs().max()))
    worst = lambda xs: max(xs) if xs and len(xs) == len(gaps) else math.inf  # noqa: E731
    return {"slice_rms": max((g[0] for g in gaps), default=math.inf),
            "slice_max_abs": max((g[1] for g in gaps), default=math.inf),
            "decode_rel_max": worst(dec), "cond_rel_max": worst(enc), "handoff_max_abs": handoff}
