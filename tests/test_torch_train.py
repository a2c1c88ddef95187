"""PyTorch port: stage-1 training (forward-process draws, loss, schedules,
optimizers, train state, the whole step, the state bridge, data, checkpoints
and the CLI) held against the JAX package on the CPU.

Random draws are the JAX ones, replayed through the port's noise interface.
Tolerances:
  * schedules: 1e-5 relative (the JAX schedules run in float32, the port's in
    float64; 1 + cos(x) near x = pi loses digits in float32);
  * optimizers and EMA: 1e-6 relative, plus 1e-9 absolute for SGD and 1e-6
    (2e-5 of the lr) for Adam / AdamW: optax takes Adam's bias corrections
    1 - beta^t in float32 with beta rounded to float32 (1 - 0.999 comes out
    1.3e-5 low), torch in float64, so one Adam update differs by ~6e-6 of
    itself;
  * the fp32 step: loss and every gradient within 1e-4 of the tensor's own
    max |.| (the fp32 UNets sum in another order; the flash site's softmax is
    the port's flash plain version against the JAX CPU path's XLA attention);
  * the bf16 step: the loss within 1e-3 of the JAX bf16 loss; every gradient
    within 3e-2 of its max |.| against the JAX *fp32* gradients (measured at
    most 1.5% over three seeds: the bf16 torso rounds every activation).  The
    JAX bf16 gradients are no yardstick for them: they differ from the JAX
    fp32 gradients by up to 11% of a tensor's max (measured, on bias
    gradients), where the port's bf16 gradients stay within 1.5%.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import train_mask as tcli
from jointimagegeneration_torch.core.checkpoint import CheckpointManager
from jointimagegeneration_torch.data.datasets import SyntheticMaskDataset as TSynth
from jointimagegeneration_torch.data.loader import DataLoader as TLoader
from jointimagegeneration_torch.diffusion import categorical as tcat
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.eval.metrics import per_class_dice as t_dice
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.train import losses as tlosses
from jointimagegeneration_torch.train.optim import build_lr_schedule as t_sched
from jointimagegeneration_torch.train.optim import build_optimizer as t_opt
from jointimagegeneration_torch.train.state import EMATrainState as TState
from jointimagegeneration_torch.train.steps import make_mask_train_step as t_step, mask_loss
from jointimagegeneration_torch.utils.jax_weights import train_state_from_jax, unet_state_dict_from_jax
from jointimagegeneration_tpu.data.datasets import SyntheticMaskDataset
from jointimagegeneration_tpu.data.loader import DataLoader
from jointimagegeneration_tpu.diffusion.categorical import CategoricalDiffusion
from jointimagegeneration_tpu.eval.metrics import per_class_dice
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler
from jointimagegeneration_tpu.train import losses as jlosses
from jointimagegeneration_tpu.train.optim import build_lr_schedule, build_optimizer
from jointimagegeneration_tpu.train.state import EMATrainState
from jointimagegeneration_tpu.train.steps import make_mask_train_step

from test_torch_weights import ReplayNoise, init_flax, load_port, to_numpy, to_torch


def _assert_scaled(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * scale, f"{what}: max abs err {err} > {frac} x max {scale}"


def _step_draws(key, b, time_steps, x0_shape):
    """The Gumbel draws of the JAX stage-1 step (steps.py:46-48), in order."""
    kt, kx, _ = jax.random.split(key, 3)
    return [("gumbel", np.asarray(jax.random.gumbel(kt, (b, time_steps), jnp.float32))),
            ("gumbel", np.asarray(jax.random.gumbel(kx, x0_shape, jnp.float32)))]


# ------------------------------------------------- forward process and loss --

def test_forward_process_draws_match_jax():
    c, T = 5, 30
    jd = CategoricalDiffusion.create("cosine", T, c)
    td = tcat.CategoricalDiffusion.create("cosine", T, c, device="cpu")
    rs = np.random.RandomState(0)
    x0 = np.eye(c, dtype=np.float32)[rs.randint(0, c, (3, 4, 4, 4))]
    key = jax.random.key(7)
    kt, kx = jax.random.split(key)
    t = jlosses.sample_train_timesteps(kt, 3, T)
    noise = ReplayNoise([("gumbel", np.asarray(jax.random.gumbel(kt, (3, T), jnp.float32)))])
    t_port = tlosses.sample_train_timesteps(noise, 3, T)
    np.testing.assert_array_equal(t_port.numpy(), np.asarray(t))
    tt = torch.tensor(np.asarray(t))
    np.testing.assert_allclose(to_numpy(td.q_xt_given_x0_probs(to_torch(x0), tt)),
                               np.asarray(jd.q_xt_given_x0_probs(jnp.asarray(x0), t)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_numpy(td.q_xt_given_xtm1_probs(to_torch(x0), tt)),
                               np.asarray(jd.q_xt_given_xtm1_probs(jnp.asarray(x0), t)), rtol=1e-6, atol=1e-7)
    want = np.asarray(jd.sample_q_xt_given_x0(kx, jnp.asarray(x0), t))
    noise = ReplayNoise([("gumbel", np.asarray(jax.random.gumbel(kx, x0.shape, jnp.float32)))])
    got = td.sample_q_xt_given_x0(noise, to_torch(x0), tt).numpy()
    assert not noise.draws and (got.sum(-1) == 1).all()
    np.testing.assert_array_equal(got, want)
    # t ~ t^1.5 puts most of its mass at large t
    many = tlosses.sample_train_timesteps(NoiseSource(0, "cpu"), 4000, T).numpy()
    assert many.min() >= 1 and many.max() <= T and np.mean(many > T // 2) > 0.6


@pytest.mark.parametrize("weights", [None, "uniform", [0.5, 1.0, 2.0, 4.0]])
def test_categorical_loss_matches_jax(weights):
    c = 4
    rs = np.random.RandomState(1)
    x0 = np.eye(c, dtype=np.float32)[rs.randint(0, c, (2, 3, 3, 3))]
    true, pred, probs = (rs.dirichlet(np.ones(c), (2, 3, 3, 3)).astype(np.float32) for _ in range(3))
    pred[0, 0, 0, 0, 0] = 0.0  # the eps clamp
    w = None if weights is None else np.ones(c, np.float32) if weights == "uniform" else np.asarray(weights, np.float32)
    jl, jm = jlosses.categorical_diffusion_loss(*(jnp.asarray(a) for a in (true, pred, x0, probs)),
                                                None if w is None else jnp.asarray(w))
    tl, tm = tlosses.categorical_diffusion_loss(*(to_torch(a) for a in (true, pred, x0, probs)),
                                                None if w is None else to_torch(w))
    for k in ("loss", "loss_kl", "loss_ce"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert float(tl) == float(tm["loss"])


# --------------------------------------------------- schedules, optimizers --

SCHEDULES = [
    (None, {}, None, 1.0),
    ("static", {}, None, 1.0),
    ("piecewise_static", {"piecewise_static_schedule": [[3, 1.0], [7, 0.5], [12, 0.1]]}, None, 1.0),
    ("exponential", {"gamma": 0.9}, None, 1.0),
    ("polynomial", {"power": 2.0, "min_lr": 1e-5}, None, 1.0),
    ("cosine", {}, None, 1.0),
    ("linear-warmup-polynomial", {"warmup_iters": 4, "warmup_rate": 0.1, "power": 1.0, "min_lr": 1e-6},
     None, 1.0),
    ("warmup-cosine", {"warm_up_steps": 3, "lr_min": 0.1, "lr_max": 1.0, "lr_start": 0.01,
                       "max_decay_steps": 15}, None, 1.0),
    ("warmup-cosine2", {"warm_up_steps": [2, 3], "f_min": [0.1, 0.2], "f_max": [1.0, 0.8],
                        "f_start": [0.0, 0.1], "cycle_lengths": [8, 12]}, None, 1.0),
    ("warmup-linear", {"warm_up_steps": [2, 3], "f_min": [0.1, 0.2], "f_max": [1.0, 0.8],
                       "f_start": [0.0, 0.1], "cycle_lengths": [8, 12]}, None, 1.0),
    ("warmup-linear", {"warm_up_steps": [5], "f_min": [1.0], "f_max": [1.0], "f_start": [1e-6],
                       "cycle_lengths": [1e13]}, None, 1.0),
    ("polynomial", {"power": 1.0, "min_lr": 1e-5}, [5, 9], 0.5),
    ("polynomial", {"power": 1.0}, [4, 5], [0.5, 0.25]),
    ("cosine", {}, [6], [0.3]),
    ("exponential", {"gamma": 0.8}, [4, 11], 0.7),
    ("static", {}, [3, 8], 0.5),
]


@pytest.mark.parametrize("fn,params,restarts,restart_vals", SCHEDULES)
def test_lr_schedules_match_jax(fn, params, restarts, restart_vals):
    base, total = 2e-3, 20
    want = build_lr_schedule(fn, base, total, params, restarts, restart_vals)
    got = t_sched(fn, base, total, params, restarts, restart_vals)
    for step in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 15, 19, 20, 25):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step, jnp.int32))), rtol=1e-5,
                                   atol=1e-9, err_msg=f"step {step}")
    with pytest.raises(ValueError):
        t_sched("nope", base, total)


@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizers_match_optax(name, clip):
    """Three updates from the same gradients, the second non-finite: it is
    skipped by both (params, optimizer count and EMA unchanged, step and
    nonfinite_count advanced), and the lr schedule reads the applied-update
    count."""
    rs = np.random.RandomState(2)
    shapes = {"w": (3, 4), "b": (4,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(name=name, learning_rate=5e-2, lr_function="polynomial",
              lr_params={"power": 1.0, "min_lr": 1e-3}, total_steps=4, grad_clip=clip)
    jstate = EMATrainState.create({k: jnp.asarray(v) for k, v in init.items()}, build_optimizer(**kw),
                                  ema_decay=0.8, ema_warmup=True)
    named = [(k, torch.nn.Parameter(to_torch(v))) for k, v in init.items()]
    tstate = TState(t_opt(named, **kw), ema_decay=0.8, ema_warmup=True)
    for i in range(3):
        g = {k: (rs.randn(*s) * (3.0 if i == 0 else 1.0)).astype(np.float32) for k, s in shapes.items()}
        if i == 1:
            g["b"][1] = np.nan
        jstate, jfinite = jstate.apply_gradients({k: jnp.asarray(v) for k, v in g.items()}, return_finite=True)
        finite = tstate.apply_gradients({k: to_torch(v) for k, v in g.items()})
        assert finite == bool(jfinite) == (i != 1)
        assert tstate.step == int(jstate.step) == i + 1
        assert tstate.nonfinite_count == int(jstate.nonfinite_count) == (1 if i >= 1 else 0)
        assert tstate.optimizer.count == (1 if i < 2 else 2)
        atol = 1e-9 if name == "SGD" else 2e-5 * kw["learning_rate"]
        for j, (k, p) in enumerate(named):
            np.testing.assert_allclose(to_numpy(p), np.asarray(jstate.params[k]), rtol=1e-6, atol=atol)
            np.testing.assert_allclose(to_numpy(tstate.ema[j]), np.asarray(jstate.ema_params[k]),
                                       rtol=1e-6, atol=atol)


# ------------------------------------------------------------- the step --

UNET = dict(num_classes=4, time_steps=20, model_channels=64, channel_mult=(1,), attention_resolutions=(1,),
            num_res_blocks=1, num_head_channels=16)
SHAPE = (1, 8, 8, 8)  # the ds-1 and mid attention sites see T = 512 tokens: the flash branch


@pytest.fixture(scope="module")
def step_setup():
    """JAX stage-1 models (fp32, bf16), their params and one batch.  Base 64
    (two channels per GroupNorm group): at base <= 32 each group holds one
    channel, a per-channel bias before the norm has a gradient of exactly
    zero in exact arithmetic, and the two frameworks' rounding noise on it
    is not comparable."""
    jm32 = MaskSampler.create(**UNET)
    jm16 = MaskSampler.create(dtype=jnp.bfloat16, **UNET)
    p = init_flax(jm32.unet, jnp.zeros((*SHAPE, 4)), jnp.zeros((1,)), cond=jnp.zeros((*SHAPE, 1)))
    item = SyntheticMaskDataset(num_cases=1, volume_shape=SHAPE[1:], num_classes=4)[0]
    cond = np.random.RandomState(3).rand(*SHAPE, 1).astype(np.float32)
    batch = {"mask": item["mask"][None], "image": cond}
    return {"float32": jm32, "bfloat16": jm16}, p, batch


def _port_model(p, dtype):
    tm = TMask.create(cond_channels=1, dtype=dtype, device="cpu", **UNET)
    load_port(tm.unet, p)
    return tm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_loss_and_grads_match_jax_value_and_grad(step_setup, dtype):
    jms, p, batch = step_setup
    bf16 = dtype == torch.bfloat16
    cw = jnp.asarray([0.5, 1.0, 2.0, 1.5])
    key = jax.random.key(11)
    x0, cond = jnp.asarray(batch["mask"]), jnp.asarray(batch["image"])

    def value_and_grad(jm):  # make_mask_train_step's loss_fn (steps.py:44-59), no refiner / features
        diff = jm.diffusion

        def loss_fn(params):
            kt, kx, _ = jax.random.split(key, 3)
            t = jlosses.sample_train_timesteps(kt, 1, diff.time_steps)
            xt = diff.sample_q_xt_given_x0(kx, x0, t)
            x0pred = jm.unet.apply(params, xt, t.astype(jnp.float32), cond=cond)
            return jlosses.categorical_diffusion_loss(diff.theta_post(xt, x0, t),
                                                      diff.theta_post_prob(xt, x0pred, t), x0, x0pred, cw)

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))({"params": p})

    (jloss, jmetrics), jgrads = value_and_grad(jms["bfloat16" if bf16 else "float32"])
    if bf16:
        _, jgrads = value_and_grad(jms["float32"])
    tm = _port_model(p, dtype)
    noise = ReplayNoise(_step_draws(key, 1, 20, x0.shape))
    loss, metrics = mask_loss(tm, noise, {k: to_torch(v) for k, v in batch.items()}, to_torch(np.asarray(cw)))
    assert not noise.draws
    named = list(tm.unet.named_parameters())
    grads = dict(zip([n for n, _ in named], torch.autograd.grad(loss, [q for _, q in named])))
    want = unet_state_dict_from_jax(jax.device_get(jgrads))
    assert sorted(want) == sorted(grads)
    loss_tol, grad_tol = (1e-3, 3e-2) if bf16 else (1e-4, 1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=loss_tol)
    for k in ("loss_kl", "loss_ce"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=loss_tol)
    for n, g in grads.items():
        _assert_scaled(to_numpy(g), want[n].numpy(), grad_tol, n)


def _train(jm, p, batch, keys, n_jax, cw):
    """A JAX AdamW state after `n_jax` steps of make_mask_train_step, host-side."""
    tx = build_optimizer("AdamW", 1e-3, "polynomial", {"power": 1.0, "min_lr": 1e-6}, total_steps=10)
    state = EMATrainState.create({"params": p}, tx, ema_decay=0.9)
    step = jax.jit(make_mask_train_step(jm, cw))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = None
    for i in range(n_jax):
        state, metrics = step(state, jb, keys[i])
    return state, metrics, step


def test_train_state_bridge_continues_a_jax_run(step_setup):
    """Two JAX steps, the state carried over with train_state_from_jax, then a
    third step on both sides: loss, params, EMA and the optimizer count
    agree (fp32)."""
    jms, p, batch = step_setup
    jm = jms["float32"]
    cw = jnp.ones((4,))
    keys = jax.random.split(jax.random.key(5), 3)
    jstate, _, jstep = _train(jm, p, batch, keys, 2, cw)
    host = jax.device_get(jstate)
    sd = train_state_from_jax(host.params, host.ema_params, host.opt_state, step=int(host.step))
    assert sd["optimizer"]["count"] == 2 and sd["step"] == 2

    tm = _port_model(p, torch.float32)
    opt = t_opt(list(tm.unet.named_parameters()), "AdamW", 1e-3, "polynomial",
                {"power": 1.0, "min_lr": 1e-6}, total_steps=10)
    tstate = TState(opt, ema_decay=0.9)
    tstate.load_state_dict(sd)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, keys[2])
    noise = ReplayNoise(_step_draws(keys[2], 1, 20, batch["mask"].shape))
    metrics = t_step(tm, to_torch(np.ones(4)))(tstate, {k: to_torch(v) for k, v in batch.items()}, noise)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert float(metrics["grad_finite"]) == 1.0 and tstate.step == 3 and tstate.optimizer.count == 3
    want_p = unet_state_dict_from_jax(jax.device_get(jstate.params))
    want_e = unet_state_dict_from_jax(jax.device_get(jstate.ema_params))
    for (n, prm), e in zip(tm.unet.named_parameters(), tstate.ema):
        got_p, got_e, wp, we = to_numpy(prm), to_numpy(e), want_p[n].numpy(), want_e[n].numpy()
        if n.endswith("qkv.bias"):
            # the key bias shifts all of a query's logits equally, so softmax
            # cancels it: its gradient is zero in exact arithmetic, and Adam
            # scales each framework's rounding noise on it up to +-lr
            c = wp.shape[0] // 3
            keep = np.r_[0:c, 2 * c:3 * c]
            got_p, got_e, wp, we = got_p[keep], got_e[keep], wp[keep], we[keep]
        np.testing.assert_allclose(got_p, wp, atol=2e-6, rtol=1e-5, err_msg=n)
        np.testing.assert_allclose(got_e, we, atol=2e-6, rtol=1e-5, err_msg=n)


# ------------------------------------------------ data, metrics, checkpoints --

def test_synthetic_dataset_bit_for_bit():
    jd, td = SyntheticMaskDataset(3, (6, 10, 12), 12, seed=2), TSynth(3, (6, 10, 12), 12, seed=2)
    assert len(td) == len(jd) == 3
    for i in range(3):
        a, b = td[i], jd[i]
        assert a["casename"] == b["casename"]
        for k in ("mask", "image"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert len(np.unique(np.argmax(td[0]["mask"], -1))) > 3


def test_loader_order_matches_jax():
    ds = TSynth(5, (4, 4, 4), 4)
    jl, tl = DataLoader(SyntheticMaskDataset(5, (4, 4, 4), 4), 2, seed=9), TLoader(ds, 2, seed=9)
    assert len(tl) == len(jl) == 2  # drop_last
    for _ in range(2):  # two epochs: the permutation follows seed + epoch
        jb, tb = list(jl), list(tl)
        assert [b["casename"] for b in tb] == [b["casename"] for b in jb]
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a["mask"].numpy(), np.asarray(b["mask"]))
    tl.set_epoch(0)
    assert [b["casename"] for b in tl] == [b["casename"] for b in TLoader(ds, 2, seed=9)]
    with pytest.raises(ValueError):
        TLoader(ds, 6)


def test_per_class_dice_matches_jax():
    rs = np.random.RandomState(4)
    a, b = rs.randint(0, 5, (6, 7, 8)), rs.randint(0, 5, (6, 7, 8))
    b[b == 3] = 0  # a class absent from the target
    for ignore in (None, 0):
        np.testing.assert_allclose(t_dice(torch.tensor(a), torch.tensor(b), 5, ignore).numpy(),
                                   np.asarray(per_class_dice(jnp.asarray(a), jnp.asarray(b), 5, ignore)),
                                   rtol=1e-6)


def test_checkpoint_manager_policies(tmp_path):
    ck = CheckpointManager(tmp_path / "ck", max_to_keep=2, best_k=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"step": s, "w": torch.full((2,), float(s))})
    for s, score in ((5, 0.1), (6, 0.5), (7, 0.3), (8, 0.2)):
        ck.save(s, {"step": s}, score=score)
    ck.save_weights(9, {"w": torch.ones(1)})
    assert ck.all_steps() == {"rolling": [3, 4], "best": [6, 7], "trainstep": [9]}
    assert ck.latest_step() == 7 and ck.best_step() == 6
    assert ck.restore()["step"] == 7 and torch.equal(ck.restore(4)["w"], torch.full((2,), 4.0))
    with pytest.raises(FileNotFoundError):
        ck.restore(1)
    assert not list((tmp_path / "ck").rglob("*.tmp"))  # writes are renamed into place
    low = CheckpointManager(tmp_path / "lo", best_mode="min")
    for s, score in ((1, 0.4), (2, 0.1), (3, 0.3)):
        low.save(s, {"step": s}, score=score)
    assert low.all_steps()["best"] == [2] and low.best_step() == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


# ------------------------------------------------------------------- CLI --

def _tiny_cfg(out, **kw):
    cfg = {"output_path": str(out), "seed": 0, "num_classes": 4, "time_steps": 20, "bf16": False,
           "batch_size": 1, "max_steps": 4, "save_freq": 2, "display_freq": 1, "validation_freq_steps": 4,
           "eval_time_steps": 2, "n_validation_images": 1, "device": "cpu",
           "optim": {"name": "AdamW", "learning_rate": 1e-3, "lr_function": "polynomial",
                     "lr_params": {"power": 1.0, "min_lr": 1e-6}},
           "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [1],
                           "num_res_blocks": 1, "num_head_channels": 4},
           "dataset": {"kind": "synthetic", "volume_shape": [8, 8, 8], "num_cases": 3}}
    cfg.update(kw)
    return cfg


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    import yaml

    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(_tiny_cfg(tmp_path / "runs")))
    tcli.main([str(cfg_path), "e1"])
    logdir = tmp_path / "runs" / "e1"
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(r["train/grad_finite"] == 1.0 and r["train/nonfinite_skipped"] == 0.0 for r in train)
    assert all(np.isfinite(r["train/loss"]) for r in train)
    assert [r["step"] for r in recs if "val/dice" in r] == [4]
    ck = CheckpointManager(logdir / "checkpoints")
    assert ck.all_steps()["rolling"] == [2, 4] and ck.all_steps()["best"] == [4]
    assert json.loads((logdir / "configs" / "run-config.json").read_text())["max_steps"] == 4
    tcli.main([str(cfg_path), "e1", "load_from=true", "max_steps=6"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert CheckpointManager(logdir / "checkpoints").all_steps()["rolling"] == [2, 4, 6]  # keeps 3
    steps = [json.loads(line)["step"] for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert steps[-2:] == [5, 6]


def test_cli_halts_on_non_finite_and_rejects_unported(tmp_path):
    cfg = _tiny_cfg(tmp_path / "r", max_steps=3, validate=False)
    cfg["optim"] = {**cfg["optim"], "learning_rate": 1e30}  # step 1 blows the params up
    with pytest.raises(FloatingPointError):
        tcli.run(cfg, "nan")
    assert CheckpointManager(tmp_path / "r" / "nan" / "checkpoints").all_steps()["rolling"] == [2]
    for bad in ({"remat": True}, {"init_from": {"path": "x"}}, {"profile_steps": 2}):
        with pytest.raises(NotImplementedError):
            tcli.run(_tiny_cfg(tmp_path / "x", **bad), "bad")
    with pytest.raises(ValueError, match="2D"):  # dino is ported, for 2D stage 1 only
        tcli.run(_tiny_cfg(tmp_path / "x", feature_cond_encoder={"type": "dino"}), "bad")
    with pytest.raises(ValueError, match="unknown dataset kind"):  # the real kinds are ported; as the JAX CLI
        tcli.run(_tiny_cfg(tmp_path / "x", dataset={"kind": "nope"}), "bad")


def test_cli_trains_with_gradient_accumulation(tmp_path):
    """optim.accumulate_steps 2: four micro-steps apply two updates, the EMA
    moves on each, and the checkpoint at step 3 holds the pending gradients."""
    cfg = _tiny_cfg(tmp_path / "a", max_steps=4, save_freq=3, validate=False)
    cfg["optim"] = {**cfg["optim"], "accumulate_steps": 2}
    state = tcli.run(cfg, "acc")
    assert state.step == 4 and state.optimizer.count == 2 and state.optimizer.mini_step == 0
    recs = [json.loads(line) for line in (tmp_path / "a" / "acc" / "metrics.jsonl").read_text().splitlines()]
    assert [r["train/grad_finite"] for r in recs] == [1.0] * 4
    saved = CheckpointManager(tmp_path / "a" / "acc" / "checkpoints").restore(3)
    assert saved["optimizer"]["count"] == 1 and saved["optimizer"]["mini_step"] == 1
    assert any(float(g.abs().max()) > 0 for g in saved["optimizer"]["acc_grads"].values())
    assert max((e - p).abs().max().item() for e, p in zip(state.ema, state.params)) > 0


def test_trainer_signals_weight_snapshots_and_empty_loader(tmp_path):
    """SIGUSR1 checkpoints at the next step, SIGTERM checkpoints and stops,
    `save_weights_every` keeps weight-only snapshots, and a loader with no
    batches raises instead of spinning; the previous handlers come back."""
    import os
    import signal

    from jointimagegeneration_torch.train.trainer import Trainer, TrainerConfig

    lin = torch.nn.Linear(3, 1)
    state = TState(t_opt(list(lin.named_parameters()), "SGD", 1e-2), ema_decay=0.5)
    sent = {1: signal.SIGUSR1, 3: signal.SIGTERM}

    def step(state, batch, noise):
        loss = (lin(batch["x"]) ** 2).mean()
        state.apply_gradients(dict(zip(state.names, torch.autograd.grad(loss, state.params))))
        if state.step in sent:
            os.kill(os.getpid(), sent[state.step])
        return {"loss": loss.detach(), "grad_finite": torch.tensor(1.0)}

    before = signal.getsignal(signal.SIGTERM)
    cfg = TrainerConfig(logdir=str(tmp_path / "t"), max_steps=10, log_every=1, save_every=100, eval_every=100,
                        save_weights_every=2)
    loader = [{"x": torch.ones(2, 3)}] * 4
    out = Trainer(cfg, state, step, loader, torch.device("cpu")).fit()
    assert out.step == 3 and signal.getsignal(signal.SIGTERM) is before
    steps = CheckpointManager(tmp_path / "t" / "checkpoints").all_steps()
    assert steps == {"rolling": [1, 3], "best": [], "trainstep": [2]}
    with pytest.raises(RuntimeError, match="no batches"):
        Trainer(TrainerConfig(logdir=str(tmp_path / "e"), max_steps=10), state, step, [],
                torch.device("cpu")).fit()
