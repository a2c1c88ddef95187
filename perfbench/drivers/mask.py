"""Traffic kind `mask`: whole stage-1 mask volumes.

The window drives the mask program of `make_chunked_two_stage_programs`, as
`cli/sample.py`'s two-stage route builds it (zero image condition): the
categorical sampler's `mask_steps` denoise steps over the t subset from T to 1,
the decode at t = 1, then the hand-off of the labels to the CT grid
`volume_shape` (`upsample_labels`, `normalize_mask_channel`).  The program is
built without its stage 2, which the mask program does not touch.  With a
text refiner in the configuration (ccdm's `feature_cond_encoder: selfattn`),
every volume is conditioned on a report: `context_tokens` seeded features of
the refiner's width, made on the card, which the refiner turns into the
context that the UNet's transformer sites cross-attend over.  One unit is one
volume; the rate counts its `mask_steps` steps.

The comparison follows the program step by step from its own state: at steps
drawn from the seed in each finished volume, and at its last (the decode),
the plain reference takes the program's labels before the step, computes the
x0 probabilities (over its own refinement of the same report features) and
the posterior in fp32 with the replayed Gumbel draw, and
scores the program's labels after the step: `label_gap` is the widest margin
by which a voxel's label scores below the reference's best (0 where the
program chose as the reference would).  The start (the first labels, from a
uniform draw) is compared exactly (`start_mismatch`, voxels that differ), and
so is the hand-off (`handoff_max_abs`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import program
from perfbench.counts import refiner_flops, unet_forward_flops
from perfbench.reference import diffusion as rd
from perfbench.reference.draws import Replay
from perfbench.reference.quant import Fp8
from perfbench.reference.unet import refiner_forward, unet_forward
from perfbench.weights import make_weights


def _shape(run):
    return (run.workload["batch"], *run.workload["mask_shape"])


def setup(run) -> None:
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.diffusion.noise import NoiseSource
    from jointimagegeneration_torch.pipeline.two_stage import (make_chunked_two_stage_programs,
                                                               normalize_mask_channel, upsample_labels)

    cfg, p = run.config, run.workload
    configure_precision()
    ms = program.mask_sampler(cfg, run.device)
    shapes = program.load_seeded(ms.unet, run.seed_of("weights"), run.device)
    shape = _shape(run)
    cond = torch.zeros((*shape, cfg["cond_channels"]), device=run.device)
    enc, context, refiner_shapes = program.text_encoder(cfg), None, None
    if enc is not None:
        refiner_shapes = program.load_seeded(ms.refiner, run.seed_of("refiner-weights"), run.device)
        g = torch.Generator(device=run.device)
        g.manual_seed(run.seed_of("context"))
        context = torch.randn((shape[0], p["context_tokens"], enc["embed_dim"]), generator=g, device=run.device)
        run.context_tokens = p["context_tokens"]
    vshape = tuple(p["volume_shape"])
    mask_program, _ = make_chunked_two_stage_programs(ms, None, mask_shape=shape, volume_shape=vshape, ddim=None,
                                                      chunk=vshape[0], mask_steps=p["mask_steps"], cond=cond,
                                                      context=context)
    run.state.update(ms=ms, program=mask_program, cond=cond, context=context, shapes=shapes,
                     refiner_shapes=refiner_shapes, volumes=[], call=0, capture={}, keep=set())
    ctx = None if enc is None else (p["context_tokens"], enc["embed_dim"])
    run.flops_per_work = unet_forward_flops(cfg, shape[0], shape[1:], cfg["num_classes"] + cfg["cond_channels"],
                                            cfg["num_classes"], context=ctx)
    if enc is not None:  # one refinement a volume
        run.flops_per_work += refiner_flops(enc, shape[0], p["context_tokens"]) / p["mask_steps"]
    run.unet_shape = (shape[0], shape[1:])

    def capture(_m, args):
        st = run.state
        if st["call"] in st["keep"]:
            st["capture"][st["call"]] = torch.argmax(args[0], dim=-1).to(torch.uint8)
        st["call"] += 1

    run.state["hooks"] = [ms.unet.register_forward_pre_hook(capture)] + run.spans.hook(ms.unet, "unet")
    if enc is not None:
        run.state["hooks"] += run.spans.hook(ms.refiner, "refiner")
    with torch.inference_mode():  # the cell's shapes: the refiner, a draw step, the decode step and the hand-off
        labels = ms.sample_labels(NoiseSource(run.seed_of("warm-up"), run.device), shape, cond=cond, num_steps=2,
                                  context=context)
        normalize_mask_channel(upsample_labels(labels, vshape), cfg["num_classes"])
    run.spans.times.clear()


def window_context(run):
    return torch.inference_mode()


def _checked_steps(run, v: int) -> list:
    """Step indices whose outcome volume v's comparison scores: `check_steps`
    draw steps from the seed, and the last step (the decode)."""
    n = run.workload["mask_steps"]
    rng = np.random.default_rng(run.seed_of("check", v) % 2**32)
    return sorted(int(k) for k in rng.choice(n - 1, size=min(run.workload["check_steps"], n - 1), replace=False)) + [
        n - 1]


def _volume(run) -> int:
    from jointimagegeneration_torch.diffusion.noise import NoiseSource

    st, n = run.state, run.workload["mask_steps"]
    v = len(st["volumes"])
    base = st["call"]
    ks = _checked_steps(run, v)
    st["keep"] = {base} | {base + k for k in ks} | {base + k + 1 for k in ks if k + 1 < n}
    up, channel = st["program"](NoiseSource(run.seed_of("noise", v), run.device))
    st["volumes"].append({"base": base, "up": up, "channel": channel})
    return n


def step(run) -> int:
    with run.spans.span("mask_volume"):
        return _volume(run)


def traced(run) -> int:
    """`trace_steps` denoise steps and the hand-off, through the program's
    sampler at the cell's shapes, under the profiler."""
    from jointimagegeneration_torch.diffusion.noise import NoiseSource
    from jointimagegeneration_torch.pipeline.two_stage import normalize_mask_channel, upsample_labels

    st, p = run.state, run.workload
    with run.spans.span("mask_volume"):
        labels = st["ms"].sample_labels(NoiseSource(run.seed_of("traced"), run.device), _shape(run),
                                        cond=st["cond"], num_steps=p["trace_steps"], context=st["context"])
        normalize_mask_channel(upsample_labels(labels, tuple(p["volume_shape"])), run.config["num_classes"])
    return p["trace_steps"]


def release(run) -> None:
    for h in run.state.pop("hooks"):
        h.remove()
    del run.state["ms"], run.state["program"]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def readings(run, control: bool = False) -> dict:
    """{name: number} of the comparison; with `control`, the fp8 reference's
    choices in the program's place, at the same states and draws."""
    cfg, p, st = run.config, run.workload, run.state
    c, n = cfg["num_classes"], p["mask_steps"]
    weights = make_weights(st["shapes"], run.seed_of("weights"), run.device)
    enc, context, context_c = program.text_encoder(cfg), None, None
    if enc is not None:  # the report's refinement, once: the same features every volume
        rw = make_weights(st["refiner_shapes"], run.seed_of("refiner-weights"), run.device)
        with torch.no_grad():
            context = refiner_forward(rw, enc, st["context"])
            context_c = refiner_forward(rw, enc, st["context"], ops=Fp8()) if control else None
        del rw
    alphas, cumalphas = rd.ccdm_schedule(cfg["time_steps"])
    tvals = rd.mask_t_values(cfg["time_steps"], n)
    shape = (*_shape(run), c)
    gap, mismatch, handoff = 0.0, 0, 0.0
    with torch.no_grad():
        for v, vol in enumerate(st["volumes"]):
            replay = Replay(run.seed_of("noise", v), run.device)
            uniform = torch.log(torch.full(shape, 1.0 / c, device=run.device).clamp_min(1e-12))
            start = torch.argmax(uniform + replay.gumbel(shape), dim=-1)
            first = st["capture"].get(vol["base"])
            if first is None:  # the program ran no UNet call where the volume began
                return {"label_gap": math.inf, "start_mismatch": start.numel(), "handoff_max_abs": math.inf}
            mismatch += int((first.long() != start).sum())
            final = vol["up"][:, ::2, ::2, ::2] if list(vol["up"].shape[1:]) == [2 * s for s in shape[1:-1]] \
                else None
            ks = set(_checked_steps(run, v))
            for k in range(n):
                g = replay.gumbel(shape)
                if k not in ks:
                    continue
                before = st["capture"].get(vol["base"] + k)
                after = st["capture"].get(vol["base"] + k + 1) if k + 1 < n else final
                if before is None or after is None:  # a step without its UNet call, or no 2x hand-off
                    gap = math.inf
                    continue
                xt, after = rd.one_hot(before, c), after.long()
                t = int(tvals[k])
                tb = torch.full((shape[0],), float(t), device=run.device)
                x0 = unet_forward(weights, cfg, xt, tb, st["cond"], softmax=True, context=context)
                scores = torch.log(rd.categorical_posterior(xt, x0, t, alphas, cumalphas).clamp_min(1e-12))
                if t > 1:
                    scores = scores + g
                if control:
                    x0c = unet_forward(weights, cfg, xt, tb, st["cond"], softmax=True, ops=Fp8(), context=context_c)
                    sc = torch.log(rd.categorical_posterior(xt, x0c, t, alphas, cumalphas).clamp_min(1e-12))
                    after = torch.argmax(sc + g if t > 1 else sc, dim=-1)
                chosen = torch.gather(scores, -1, after[..., None])[..., 0]
                gap = max(gap, float((scores.amax(dim=-1) - chosen).max()))
            if final is None:
                handoff = math.inf
                continue
            ref_up = rd.upsample_nearest(final, tuple(p["volume_shape"]))
            handoff = max(handoff, float((vol["up"] != ref_up).sum()),
                          float((vol["channel"][..., 0] - ref_up.float() / (c - 1)).abs().max()))
    return {"label_gap": gap, "start_mismatch": mismatch, "handoff_max_abs": handoff}

