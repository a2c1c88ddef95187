"""Traffic kind `train`: stage 2's train step, fed by the loader.

Set-up builds one object, the program's train step over its `EMATrainState`
(AdamW, the EMA) as `cli/train_ldm.py` builds it, with the program's
`DataLoader` (`loader_threads` threads, pinned copies to the card) over the
benchmark's seeded rows, made once in set-up so that each item costs the
loader the same; consecutive rows differ.  It drives that object through its
first `check_steps` steps by the window's own call, which warms every shape,
then hands it to the window.  One unit is one optimizer step.

The comparison replays those first steps with the plain reference in fp32
(the same rows, the replayed draws, its own AdamW and EMA, from the same
seeded weights): `loss_gap`, the largest relative gap of a step's loss;
`grad_gap`, the worst leaf's gap between the norms of the first gradient
(the program's read back from AdamW's first moment after one step), over the
larger of that leaf's reference norm and the median leaf's; `change_gap`, the
same for the parameters' change over the steps, and `ema_gap` for the EMA's
change, on the leaves whose reference gradient is at least a thousandth of
the median leaf's (the others move by round-off alone under Adam).
`ema_step_gap` holds the program's EMA to the published rule (LitEma's
warm-up, or the constant Polyak decay) applied by the reference to the
program's own parameters after each of those steps (kept on the host in
set-up), by the same measure: it follows the program's state, whose
parameters `change_gap` judges on their own.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from perfbench import program
from perfbench.counts import unet_forward_flops
from perfbench.reference import train as rt
from perfbench.reference.draws import Replay
from perfbench.reference.quant import Fp8
from perfbench.weights import make_weights


class SliceRows:
    """`n` seeded slice pairs at `size`^2, made once: "image" (H, W, 1) in
    [0, 1), "cond" (H, W, 2) = [previous slice in [0, 1) | labels / (C - 1)].
    Row i is pair i mod n, so consecutive rows differ and every item costs
    the loader the same."""

    def __init__(self, seed: int, size: int, num_classes: int, n: int = 16):
        rng = np.random.default_rng(seed)
        hw = (n, size, size, 1)
        labels = rng.integers(0, num_classes, size=hw).astype(np.float32) / (num_classes - 1)
        self.image = rng.random(hw, dtype=np.float32)
        self.cond = np.concatenate([rng.random(hw, dtype=np.float32), labels], axis=-1)

    def __len__(self) -> int:
        return 100_000

    def __getitem__(self, i: int) -> dict:
        j = i % len(self.image)
        return {"image": self.image[j], "cond": self.cond[j]}


def _lr(opt: dict, step: int) -> float:
    """The reference's learning rate at `step`: the cells train at a constant
    rate, as `configs/stage2_ldm.yml` does."""
    if opt.get("lr_function") is not None:
        raise ValueError(f"no reference schedule for {opt['lr_function']!r}")
    return float(opt["learning_rate"])


def setup(run) -> None:
    from jointimagegeneration_torch.core.runtime import configure_precision
    from jointimagegeneration_torch.data.loader import DataLoader
    from jointimagegeneration_torch.diffusion.noise import NoiseSource
    from jointimagegeneration_torch.train.optim import build_optimizer
    from jointimagegeneration_torch.train.state import EMATrainState
    from jointimagegeneration_torch.train.steps import make_ldm_train_step

    cfg, p = run.config, run.workload
    configure_precision()
    model = program.slice_ldm(cfg, run.device)
    step_fn = make_ldm_train_step(model)
    rows = SliceRows(run.seed_of("rows") % 2**32, p["slice_size"], p["num_classes"])
    spatial = (p["slice_size"],) * 2
    in_ch, out_ch = cfg["image_channels"] + cfg["cond_channels"], cfg["image_channels"]
    shapes = program.load_seeded(model.unet, run.seed_of("weights"), run.device)
    opt = p["optimizer"]
    optimizer = build_optimizer(model.named_parameters(), "AdamW", opt["learning_rate"],
                                lr_function=opt.get("lr_function"), lr_params=opt.get("lr_params"),
                                total_steps=int(opt["total_steps"]))
    state = EMATrainState(optimizer, ema_decay=p["ema_decay"], ema_warmup=p["ema_warmup"])
    loader = DataLoader(rows, batch_size=p["batch"], shuffle=False, device=run.device,
                        num_workers=p["loader_threads"])
    batches = itertools.chain.from_iterable(iter(loader) for _ in itertools.count())
    names = [n for n, _ in model.named_parameters()]
    run.state.update(model=model, step_fn=step_fn, train_state=state, batches=batches, shapes=shapes, names=names,
                     noise=NoiseSource(run.seed_of("noise"), run.device), seen=[], losses=[])
    run.flops_per_work = 3 * unet_forward_flops(cfg, p["batch"], spatial, in_ch, out_ch)
    run.unet_shape, run.unet_backward = (p["batch"], spatial), True
    run.state["hooks"] = run.spans.hook(model.unet, "unet")
    params = [q for _, q in model.named_parameters()]
    trajectory = []  # the program's parameters after each first step, on the host
    for i in range(p["check_steps"]):  # the first steps, by the window's own call
        step(run, keep=True)
        trajectory.append([q.detach().to("cpu", torch.float32, copy=True) for q in params])
        if i == 0:
            b1 = optimizer.torch_opt.param_groups[0]["betas"][0]
            moments = [optimizer.torch_opt.state.get(q, {}).get("exp_avg") for q in params]
            run.state["grad_norms"] = [0.0 if m is None else float(torch.linalg.vector_norm(m)) / (1.0 - b1)
                                       for m in moments]  # no moment: the optimizer got no gradient
    start = make_weights(shapes, run.seed_of("weights"), run.device)
    run.state["change_norms"] = [float(torch.linalg.vector_norm(q.detach() - start[n]))
                                 for n, q in model.named_parameters()]
    ema = dict(zip(state.names, state.ema))
    run.state["ema_norms"] = [float(torch.linalg.vector_norm(ema[n] - start[n])) for n in names]
    run.state["trajectory"] = trajectory
    del start
    run.spans.times.clear()


def step(run, keep: bool = False) -> int:
    st = run.state
    with run.spans.span("train_step"):
        with run.spans.span("loader_wait"):
            batch = next(st["batches"])
        metrics = st["step_fn"](st["train_state"], batch, st["noise"])
    if keep:
        st["seen"].append({k: v.clone() for k, v in batch.items() if isinstance(v, torch.Tensor)})
        st["losses"].append(float(metrics["loss"]))
    return 1


def traced(run) -> int:
    for _ in range(run.workload["trace_steps"]):
        step(run)
    return run.workload["trace_steps"]


def release(run) -> None:
    for h in run.state.pop("hooks"):
        h.remove()
    for k in ("model", "step_fn", "train_state", "batches"):
        del run.state[k]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def readings(run, control: bool = False) -> dict:
    """{name: number}; with `control`, the fp8 reference's steps in the
    program's place."""
    cfg, p, st = run.config, run.workload, run.state
    names = st["names"]
    start = make_weights(st["shapes"], run.seed_of("weights"), run.device)
    ema_rule = rt.Ema(p["ema_decay"], p["ema_warmup"])

    def replay_steps(ops):
        params = {n: start[n].clone().requires_grad_(True) for n in names}
        opt = rt.AdamW(params, weight_decay=0.01)
        ema = {n: start[n].clone() for n in names}
        replay = Replay(run.seed_of("noise"), run.device)
        losses, first = [], None
        for i, batch in enumerate(st["seen"]):
            loss = rt.ldm_loss(params, cfg, batch, replay, ops=ops)
            grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
            losses.append(float(loss.detach()))
            if i == 0:
                first = rt.leaf_norms(grads, names)
            opt.step(grads, _lr(p["optimizer"], i))
            ema_rule.update(ema, params, i)
            del loss, grads
        change = rt.leaf_norms({n: params[n].detach() - start[n] for n in names}, names)
        return losses, first, change, rt.leaf_norms({n: ema[n] - start[n] for n in names}, names)

    ref_losses, ref_grad, ref_change, ref_ema = replay_steps(None)
    if control:
        losses, grad, change, ema_norms = replay_steps(Fp8())
        step_gap = 0.0  # the control's EMA is the reference's rule itself
    else:
        losses, grad, change, ema_norms = st["losses"], st["grad_norms"], st["change_norms"], st["ema_norms"]
        step_gap = _ema_step_gap(st, names, start, ema_rule, run.device)
    median = sorted(ref_grad)[len(ref_grad) // 2]
    moved = [g >= 1e-3 * median for g in ref_grad]
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad_gaps = rt.relative_gaps(grad, ref_grad, [True] * len(names))
    change_gaps = rt.relative_gaps(change, ref_change, moved)
    ema_gaps = rt.relative_gaps(ema_norms, ref_ema, moved)
    worst = lambda gaps: gaps[-1] if gaps else (math.inf, -1)
    median = lambda gaps: gaps[len(gaps) // 2][0] if gaps else math.inf
    return {"loss_gap": max(loss_gaps, default=math.inf), "loss_gap_first": loss_gaps[0] if loss_gaps else math.inf,
            "grad_gap": worst(grad_gaps)[0], "grad_gap_median": median(grad_gaps),
            "change_gap": worst(change_gaps)[0], "change_gap_median": median(change_gaps),
            "ema_gap": worst(ema_gaps)[0], "ema_step_gap": step_gap,
            "worst_leaves": {"grad": names[worst(grad_gaps)[1]], "change": names[worst(change_gaps)[1]],
                             "ema": names[worst(ema_gaps)[1]]},
            "losses": losses, "ref_losses": ref_losses}


def _ema_step_gap(st, names, start, ema_rule, device) -> float:
    """The worst leaf's gap between the norm of the program's EMA change and
    that of the reference's rule applied to the program's own parameters
    after each first step, over the larger of the latter and the median
    leaf's; every leaf that moved in the reference counts."""
    ema = {n: start[n].double() for n in names}
    for i, params in enumerate(st["trajectory"]):
        ema_rule.update(ema, {n: q.to(device, torch.float64) for n, q in zip(names, params)}, i)
    ref = rt.leaf_norms({n: ema[n] - start[n].double() for n in names}, names)
    gaps = rt.relative_gaps(st["ema_norms"], ref, [r > 0 for r in ref])
    return gaps[-1][0] if gaps else math.inf
