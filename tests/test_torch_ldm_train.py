"""PyTorch port: stage-2 training (the Gaussian process, its loss, the whole
step, gradient accumulation, the synthetic slice data, the state bridge and
the CLI) held against the JAX package on the CPU.

Random draws are the JAX ones, replayed through the port's noise interface
(`ReplayNoise`: the step's randint timesteps, then its normals).  Tolerances:
  * the Gaussian buffers: bit for bit, for 'eps' and 'x0' (both compute in
    float64 numpy and store float32); q_sample, predict_x0, q_posterior and
    p_sample within rtol 1e-6 (fp32 products in the same order);
  * gaussian_diffusion_loss: rtol 1e-6;
  * the fp32 step: loss rtol 1e-4, every gradient within 1e-4 of its own max
    |.| (the fp32 UNets sum in another order; the T = 512 attention sites are
    the port's flash plain version against the JAX CPU path's XLA attention);
  * the bf16 step: loss rtol 1e-3 of the JAX bf16 loss, every gradient within
    3e-2 of its max |.| against the JAX *fp32* gradients, as in
    test_torch_train.py (the JAX bf16 gradients are no yardstick: they differ
    from its own fp32 ones by up to 11% on bias gradients);
  * optimizers, EMA and accumulation: rtol 1e-6, plus 1e-9 absolute for SGD
    and 2e-5 of the lr for Adam / AdamW (optax takes Adam's bias corrections
    in float32, torch in float64; test_torch_train.py);
  * the state bridge: loss rtol 1e-4, params and EMA within 2e-6 + 1e-5
    relative after one more AdamW step (test_torch_train.py's bridge test);
  * the synthetic slices: bit for bit, or within one float32 ulp where the
    JAX package's native `window_norm` (a multiply by 1/W) is built.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import train_ldm as tcli
from jointimagegeneration_torch.cli.sample import build_slice_ldm
from jointimagegeneration_torch.core.checkpoint import CheckpointManager
from jointimagegeneration_torch.core.config import apply_overrides
from jointimagegeneration_torch.data.datasets import SyntheticSliceDataset as TSlices
from jointimagegeneration_torch.data.transforms import window_norm as t_window_norm
from jointimagegeneration_torch.diffusion.gaussian import GaussianDiffusion as TGauss
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.train import losses as tlosses
from jointimagegeneration_torch.train.optim import build_optimizer as t_opt
from jointimagegeneration_torch.train.state import EMATrainState as TState
from jointimagegeneration_torch.train.steps import ldm_loss, make_ldm_train_step as t_step
from jointimagegeneration_torch.train.trainer import noise_seed
from jointimagegeneration_torch.utils.jax_weights import train_state_from_jax, unet_state_dict_from_jax
from jointimagegeneration_tpu.data.datasets import SyntheticSliceDataset
from jointimagegeneration_tpu.data.native import native_available
from jointimagegeneration_tpu.data.transforms import window_norm
from jointimagegeneration_tpu.diffusion.gaussian import GaussianDiffusion
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM
from jointimagegeneration_tpu.train import losses as jlosses
from jointimagegeneration_tpu.train.optim import build_optimizer
from jointimagegeneration_tpu.train.state import EMATrainState
from jointimagegeneration_tpu.train.steps import make_ldm_train_step

from test_torch_weights import ReplayNoise, init_flax, load_port, to_numpy, to_torch

BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
           "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
           "posterior_variance", "posterior_log_variance_clipped", "posterior_mean_coef1",
           "posterior_mean_coef2", "lvlb_weights")


def _assert_scaled(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * scale, f"{what}: max abs err {err} > {frac} x max {scale}"


def _ldm_draws(key, b, num_timesteps, shape):
    """The draws of the JAX stage-2 step (steps.py:90-92), in order."""
    kt, kn = jax.random.split(key)
    return [("randint", np.asarray(jax.random.randint(kt, (b,), 0, num_timesteps))),
            ("normal", np.asarray(jax.random.normal(kn, shape, jnp.float32)))]


# ------------------------------------------------------ the Gaussian process --

@pytest.mark.parametrize("parameterization", ["eps", "x0"])
def test_gaussian_buffers_and_maps_match_jax(parameterization):
    kw = dict(linear_start=0.0015, linear_end=0.0195, parameterization=parameterization)
    jd, td = GaussianDiffusion.create("linear", 1000, **kw), TGauss.create("linear", 1000, **kw)
    assert td.num_timesteps == jd.num_timesteps == 1000 and td.parameterization == parameterization
    for name in BUFFERS:
        want = np.asarray(getattr(jd, name))
        assert getattr(td, name).dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(getattr(td, name), want, err_msg=name)
    rs = np.random.RandomState(0)
    x0, xt, out = (rs.randn(3, 4, 5, 1).astype(np.float32) for _ in range(3))
    eps = rs.randn(3, 4, 5, 1).astype(np.float32)
    t = np.array([0, 417, 999], np.int32)
    jt, tt = jnp.asarray(t), torch.tensor(t)
    close = lambda a, b: np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    close(td.q_sample(to_torch(x0), tt, to_torch(eps)), jd.q_sample(jnp.asarray(x0), jt, jnp.asarray(eps)))
    for clip in (True, False):
        close(td.predict_x0(to_torch(out), to_torch(xt), tt, clip),
              jd.predict_x0(jnp.asarray(out), jnp.asarray(xt), jt, clip))
    for a, b in zip(td.q_posterior(to_torch(x0), to_torch(xt), tt),
                    jd.q_posterior(jnp.asarray(x0), jnp.asarray(xt), jt)):
        close(a, b)
    key = jax.random.key(3)
    want = jd.p_sample(key, jnp.asarray(out), jnp.asarray(xt), jt)
    noise = ReplayNoise([("normal", np.asarray(jax.random.normal(key, xt.shape, jnp.float32)))])
    close(td.p_sample(noise, to_torch(out), to_torch(xt), tt), want)
    assert not noise.draws


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("with_logvar", [False, True])
@pytest.mark.parametrize("elbo", [0.0, 0.5])
def test_gaussian_loss_matches_jax(loss_type, with_logvar, elbo):
    rs = np.random.RandomState(1)
    out, target = rs.randn(3, 4, 4, 1).astype(np.float32), rs.randn(3, 4, 4, 1).astype(np.float32)
    t = np.array([2, 7, 2], np.int64)
    lvlb = rs.rand(10).astype(np.float32)
    logvar = (0.3 * rs.randn(10)).astype(np.float32) if with_logvar else None
    jl, jm = jlosses.gaussian_diffusion_loss(jnp.asarray(out), jnp.asarray(target), jnp.asarray(t), jnp.asarray(lvlb),
                                             loss_type, None if logvar is None else jnp.asarray(logvar),
                                             l_simple_weight=0.7, elbo_weight=elbo)
    tl, tm = tlosses.gaussian_diffusion_loss(to_torch(out), to_torch(target), torch.tensor(t), to_torch(lvlb),
                                             loss_type, None if logvar is None else to_torch(logvar),
                                             l_simple_weight=0.7, elbo_weight=elbo)
    for k in ("loss", "loss_simple", "loss_vlb"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert float(tl) == float(tm["loss"])
    with pytest.raises(ValueError):
        tlosses.gaussian_diffusion_loss(to_torch(out), to_torch(target), torch.tensor(t), to_torch(lvlb), "huber")


# ------------------------------------------------------------- the step --

LDM = dict(model_channels=64, channel_mult=(1,), attention_resolutions=(1,), num_res_blocks=1,
           num_head_channels=16)
SHAPE = (2, 16, 32)  # B, H, W: the ds-1 and mid attention sites see T = 512 tokens, the flash branch


@pytest.fixture(scope="module")
def ldm_setup():
    """JAX stage-2 models (fp32, bf16), UNet params with every leaf non-zero,
    a logvar, one batch, and a cache of JAX loss-and-gradient results.  Base
    64: at base <= 32 every GroupNorm group holds one channel and the bias
    before it has an exactly zero gradient, whose rounding noise the two
    frameworks do not share."""
    jms = {"float32": SliceLDM.create(**LDM), "bfloat16": SliceLDM.create(dtype=jnp.bfloat16, **LDM)}
    b, h, w = SHAPE
    p = init_flax(jms["float32"].unet, jnp.zeros((1, h, w, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, h, w, 2)))
    rs = np.random.RandomState(7)
    logvar = (0.2 * rs.randn(1000)).astype(np.float32)
    batch = {"image": rs.rand(b, h, w, 1).astype(np.float32), "cond": rs.rand(b, h, w, 2).astype(np.float32)}
    return jms, p, logvar, batch, {}


def _jax_value_and_grad(setup, dtype: str, with_logvar: bool, elbo: float):
    """make_ldm_train_step's loss_fn (steps.py:88-100), differentiated."""
    jms, p, logvar, batch, cache = setup
    if (dtype, with_logvar) not in cache:
        jm = jms[dtype]
        diff = jm.diffusion
        key = jax.random.key(11)
        x0, cond = jnp.asarray(batch["image"]), jnp.asarray(batch["cond"])

        def loss_fn(params):
            kt, kn = jax.random.split(key)
            t = jax.random.randint(kt, (x0.shape[0],), 0, diff.num_timesteps)
            noise = jax.random.normal(kn, x0.shape, x0.dtype)
            out = jm.apply_model(params, diff.q_sample(x0, t, noise), t, cond=cond)
            lv = params["logvar"] if "logvar" in params else None
            return jlosses.gaussian_diffusion_loss(out, noise, t, diff.lvlb_weights, "l2", logvar=lv,
                                                   elbo_weight=elbo)

        params = {"unet": {"params": p}, "logvar": jnp.asarray(logvar)} if with_logvar else {"params": p}
        cache[(dtype, with_logvar)] = jax.device_get(jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params))
    return cache[(dtype, with_logvar)]


def _port_ldm(p, logvar, dtype, **kw):
    ts = TSlice.create(dtype=dtype, device="cpu", learn_logvar=logvar is not None, **LDM, **kw)
    load_port(ts.unet, p)
    if logvar is not None:
        with torch.no_grad():
            ts.logvar.copy_(to_torch(logvar))
    return ts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_logvar", [False, True])
def test_ldm_loss_and_grads_match_jax_value_and_grad(ldm_setup, dtype, with_logvar):
    jms, p, logvar, batch, _ = ldm_setup
    bf16, elbo = dtype == torch.bfloat16, 0.25
    (jloss, jmetrics), jgrads = _jax_value_and_grad(ldm_setup, "bfloat16" if bf16 else "float32", with_logvar, elbo)
    if bf16:
        _, jgrads = _jax_value_and_grad(ldm_setup, "float32", with_logvar, elbo)
    ts = _port_ldm(p, logvar if with_logvar else None, dtype)
    noise = ReplayNoise(_ldm_draws(jax.random.key(11), SHAPE[0], 1000, (*SHAPE, 1)))
    loss, metrics = ldm_loss(ts, noise, {k: to_torch(v) for k, v in batch.items()}, elbo_weight=elbo)
    assert not noise.draws
    named = ts.named_parameters()
    assert (named[-1][0] == "logvar") == with_logvar
    grads = dict(zip([n for n, _ in named], torch.autograd.grad(loss, [q for _, q in named])))
    want = unet_state_dict_from_jax(jgrads)
    assert sorted(want) == sorted(grads)
    loss_tol, grad_tol = (1e-3, 3e-2) if bf16 else (1e-4, 1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=loss_tol)
    for k in ("loss_simple", "loss_vlb"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=loss_tol)
    for n, g in grads.items():
        _assert_scaled(to_numpy(g), want[n].numpy(), grad_tol, n)
    # class ids on a UNet without adm_classes are ignored, as the flax UNet ignores them
    again = ReplayNoise(_ldm_draws(jax.random.key(11), SHAPE[0], 1000, (*SHAPE, 1)))
    loss_y, _ = ldm_loss(ts, again, {**{k: to_torch(v) for k, v in batch.items()}, "y": torch.zeros(2)},
                         elbo_weight=elbo)
    assert float(loss_y.detach()) == float(loss.detach())


# ---------------------------------------------------- gradient accumulation --

@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_accumulation_matches_optax_multisteps(name, clip):
    """Five micro-steps with accumulate_steps 2, the third non-finite: the
    JAX state (optax.MultiSteps inside EMATrainState) and the port's agree on
    params, EMA, step, nonfinite_count and the applied-update count after
    each; the port's state is saved and restored mid-accumulation on the way."""
    rs = np.random.RandomState(2)
    shapes = {"w": (3, 4), "b": (4,)}
    init = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(name=name, learning_rate=5e-2, lr_function="polynomial",
              lr_params={"power": 1.0, "min_lr": 1e-3}, total_steps=4, grad_clip=clip, accumulate_steps=2)
    jstate = EMATrainState.create({k: jnp.asarray(v) for k, v in init.items()}, build_optimizer(**kw),
                                  ema_decay=0.8, ema_warmup=True)
    named = [(k, torch.nn.Parameter(to_torch(v))) for k, v in init.items()]
    tstate = TState(t_opt(named, **kw), ema_decay=0.8, ema_warmup=True)
    atol = 1e-9 if name == "SGD" else 2e-5 * kw["learning_rate"]
    for i in range(5):
        g = {k: (rs.randn(*s) * (3.0 if i == 0 else 1.0)).astype(np.float32) for k, s in shapes.items()}
        if i == 2:
            g["w"][0, 1] = np.inf
        jstate, jfinite = jstate.apply_gradients({k: jnp.asarray(v) for k, v in g.items()}, return_finite=True)
        finite = tstate.apply_gradients({k: to_torch(v) for k, v in g.items()})
        assert finite == bool(jfinite) == (i != 2)
        assert tstate.step == int(jstate.step) == i + 1
        assert tstate.nonfinite_count == int(jstate.nonfinite_count) == (1 if i >= 2 else 0)
        assert tstate.optimizer.count == int(jstate.opt_state.gradient_step) == [0, 1, 1, 1, 2][i]
        assert tstate.optimizer.mini_step == int(jstate.opt_state.mini_step) == [1, 0, 0, 1, 0][i]
        for j, (k, prm) in enumerate(named):
            np.testing.assert_allclose(to_numpy(prm), np.asarray(jstate.params[k]), rtol=1e-6, atol=atol)
            np.testing.assert_allclose(to_numpy(tstate.ema[j]), np.asarray(jstate.ema_params[k]),
                                       rtol=1e-6, atol=atol)
        if i == 3:  # mid-accumulation: a resumed state continues it
            sd = tstate.state_dict()
            np.testing.assert_allclose(sd["optimizer"]["acc_grads"]["b"].numpy(),
                                       np.asarray(jstate.opt_state.acc_grads["b"]), rtol=1e-6)
            named = [(k, torch.nn.Parameter(torch.zeros(s))) for k, s in shapes.items()]
            tstate = TState(t_opt(named, **kw), ema_decay=0.8, ema_warmup=True)
            tstate.load_state_dict(sd)


def _two_param_opt(k):
    named = [("w", torch.nn.Parameter(torch.ones(3))), ("b", torch.nn.Parameter(torch.zeros(2)))]
    return t_opt(named, "SGD", 0.1, accumulate_steps=k)


@pytest.mark.parametrize("saved_k,micro,drop,load_k,ok", [
    (2, 1, None, 1, False),  # pending gradients, no accumulator to take them
    (2, 1, None, 3, False),  # pending gradients of another accumulation length
    (2, 1, "accumulate_steps", 1, False),  # as bridged from optax: mini_step 1 cannot fit k = 1
    (2, 1, "b", 2, False),  # an accumulated gradient missing
    (2, 1, "accumulate_steps", 2, True),
    (2, 2, None, 1, True),  # at an update boundary: nothing pending
    (1, 3, None, 2, True),  # saved without accumulation: the accumulator starts at zero
])
def test_optimizer_resume_refuses_a_pending_accumulation_it_cannot_continue(saved_k, micro, drop, load_k, ok):
    old = _two_param_opt(saved_k)
    for _ in range(micro):
        old.step([torch.ones(3), torch.ones(2)])
    sd = old.state_dict()
    if drop == "accumulate_steps":  # train_state_from_jax does not know it
        del sd["accumulate_steps"]
    elif drop:
        del sd["acc_grads"][drop]
    opt = _two_param_opt(load_k)
    if not ok:
        with pytest.raises(ValueError, match="micro-steps into an accumulation"):
            opt.load_state_dict(sd)
        return
    opt.load_state_dict(sd)
    assert opt.count == sd["count"] and opt.mini_step == sd.get("mini_step", 0) % load_k
    if opt.acc_grads is not None:
        want = sd["acc_grads"]["w"] if sd.get("mini_step") else torch.zeros(3)
        assert torch.equal(opt.acc_grads[0], want)


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("include_volumes", [False, True])
def test_synthetic_slice_dataset_matches_jax(include_volumes):
    jd = SyntheticSliceDataset(3, (12, 20), depth=5, num_classes=12, include_volumes=include_volumes, seed=1)
    td = TSlices(3, (12, 20), depth=5, num_classes=12, include_volumes=include_volumes, seed=1)
    assert len(td) == len(jd) == 3
    for i in range(3):
        a, b = td[i], jd[i]
        assert sorted(a) == sorted(b) and a["casename"] == b["casename"]
        for k in a:
            if k == "casename":
                continue
            assert a[k].dtype == b[k].dtype == np.float32 and a[k].shape == b[k].shape, k
            if native_available():  # the JAX package's C window_norm multiplies by 1/W
                np.testing.assert_array_max_ulp(a[k], b[k], maxulp=1)
            else:
                np.testing.assert_array_equal(a[k], b[k])
    assert td[0]["cond"].shape == (12, 20, 2) and 0.0 <= td[0]["image"].min() <= td[0]["image"].max() <= 1.0
    hu = np.random.RandomState(5).randn(4, 7) * 300.0
    np.testing.assert_array_equal(t_window_norm(hu, 40.0, 400.0), window_norm(hu, 40.0, 400.0))


# --------------------------------------------------------- the state bridge --

@pytest.fixture(scope="module")
def bridge_setup(ldm_setup):
    """A JAX AdamW stage-2 run with learn_logvar and accumulate_steps 2 (fp32):
    the jitted step and its states after each of three steps."""
    jms, p, logvar, batch, _ = ldm_setup
    jm = jms["float32"]
    tx = build_optimizer("AdamW", 1e-3, "polynomial", {"power": 1.0, "min_lr": 1e-6}, total_steps=10,
                         accumulate_steps=2)
    state = EMATrainState.create({"unet": {"params": p}, "logvar": jnp.asarray(logvar)}, tx, ema_decay=0.9,
                                 ema_warmup=True)
    step = jax.jit(make_ldm_train_step(jm, elbo_weight=0.25))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    keys = jax.random.split(jax.random.key(5), 4)
    states = []
    for i in range(3):
        state, _ = step(state, jb, keys[i])
        states.append(state)
    return step, states, keys, jb


@pytest.mark.parametrize("n_jax", [2, 3])
def test_train_state_bridge_continues_a_jax_ldm_run(ldm_setup, bridge_setup, n_jax):
    """`n_jax` JAX steps (2: at an accumulation boundary; 3: one micro-step
    into the next accumulation), the state carried over with
    train_state_from_jax, then one more step on both sides: loss, params
    (logvar included), EMA, step and the optimizer's counts agree."""
    _, p, logvar, batch, _ = ldm_setup
    jstep, states, keys, jb = bridge_setup
    host = jax.device_get(states[n_jax - 1])
    sd = train_state_from_jax(host.params, host.ema_params, host.opt_state, step=int(host.step))
    assert sd["optimizer"]["count"] == 1 and sd["step"] == n_jax
    assert sd["optimizer"]["mini_step"] == n_jax % 2 and "logvar" in sd["optimizer"]["acc_grads"]

    ts = _port_ldm(p, logvar, torch.float32)
    opt = t_opt(ts.named_parameters(), "AdamW", 1e-3, "polynomial", {"power": 1.0, "min_lr": 1e-6},
                total_steps=10, accumulate_steps=2)
    tstate = TState(opt, ema_decay=0.9, ema_warmup=True)
    tstate.load_state_dict(sd)
    jstate, jmetrics = jstep(states[n_jax - 1], jb, keys[n_jax])
    noise = ReplayNoise(_ldm_draws(keys[n_jax], SHAPE[0], 1000, (*SHAPE, 1)))
    metrics = t_step(ts, elbo_weight=0.25)(tstate, {k: to_torch(v) for k, v in batch.items()}, noise)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert float(metrics["grad_finite"]) == 1.0 and tstate.step == n_jax + 1
    assert tstate.optimizer.count == int(jstate.opt_state.gradient_step) == (n_jax + 1) // 2
    want_p = unet_state_dict_from_jax(jax.device_get(jstate.params))
    want_e = unet_state_dict_from_jax(jax.device_get(jstate.ema_params))
    assert sorted(want_p) == sorted(tstate.names)
    for n, prm, e in zip(tstate.names, tstate.params, tstate.ema):
        got_p, got_e, wp, we = to_numpy(prm), to_numpy(e), want_p[n].numpy(), want_e[n].numpy()
        if n.endswith("qkv.bias"):
            # the key bias's gradient is zero in exact arithmetic (softmax
            # cancels it), and Adam scales each framework's rounding noise on
            # it up to +-lr (test_torch_train.py's bridge test)
            c = wp.shape[0] // 3
            keep = np.r_[0:c, 2 * c:3 * c]
            got_p, got_e, wp, we = got_p[keep], got_e[keep], wp[keep], we[keep]
        np.testing.assert_allclose(got_p, wp, atol=2e-6, rtol=1e-5, err_msg=n)
        np.testing.assert_allclose(got_e, we, atol=2e-6, rtol=1e-5, err_msg=n)


# ------------------------------------------------------------------- CLI --

def _tiny_cfg(out, **kw):
    cfg = {"output_path": str(out), "seed": 0, "batch_size": 2, "max_steps": 4, "save_freq": 2, "display_freq": 1,
           "eval_every": 2, "n_log_images": 2, "num_workers": 1, "device": "cpu", "accumulate_grad_batches": 2,
           "model": {"base_learning_rate": 1e-4, "timesteps": 100, "bf16": False, "learn_logvar": True,
                     "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2],
                                                "attention_resolutions": [1], "num_res_blocks": 1,
                                                "num_head_channels": 4}}},
           "dataset": {"kind": "synthetic", "slice_shape": [16, 16], "depth": 4, "num_cases": 3}}
    cfg.update(kw)
    return cfg


def _val_loss(cfg, weights, step):
    """The validation score of `weights` (name -> tensor) after `step`,
    recomputed outside the CLI: the l2 eps loss at t = 50 (T / 2) on the first
    two val items as one batch, the noise from the stream seeded for step + 1."""
    model = build_slice_ldm(cfg["model"], "cpu", learn_logvar=True)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    val = tcli.build_slice_dataset(cfg, "val")
    x0, cond = (torch.from_numpy(np.stack([val[i][k] for i in range(2)])) for k in ("image", "cond"))
    t = torch.full((2,), 50)
    eps = NoiseSource(noise_seed(cfg["seed"], step + 1), "cpu").normal(x0.shape)
    with torch.no_grad():
        out = model.apply_model(model.diffusion.q_sample(x0, t, eps), t, cond=cond)
    return float(((out - eps) ** 2).mean())


def test_ldm_cli_trains_validates_checkpoints_and_resumes(tmp_path, capsys):
    import yaml

    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(_tiny_cfg(tmp_path / "runs")))
    tcli.main([str(cfg_path), "e1"])
    out = capsys.readouterr().out
    assert "lr=4.00e-04" in out  # accumulate 2 x batch 2 x base 1e-4
    logdir = tmp_path / "runs" / "e1"
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(r["train/grad_finite"] == 1.0 and r["train/nonfinite_skipped"] == 0.0 for r in train)
    assert all(np.isfinite([r["train/loss"], r["train/loss_simple"], r["train/loss_vlb"]]).all() for r in train)
    val = [r for r in recs if "val/loss_simple" in r]
    assert [r["step"] for r in val] == [2, 4] and all(r["val/loss_simple"] > 0 for r in val)
    ck = CheckpointManager(logdir / "checkpoints")
    assert ck.all_steps()["rolling"] == [2, 4] and len(ck.all_steps()["best"]) == 1
    saved = ck.restore(4)
    assert saved["optimizer"]["count"] == 2 and saved["optimizer"]["mini_step"] == 0
    assert saved["params"]["logvar"].shape == (100,) and saved["step"] == 4
    # the logged score is the EMA weights', not the training weights'
    cfg = _tiny_cfg(tmp_path / "runs")
    np.testing.assert_allclose(val[-1]["val/loss_simple"], _val_loss(cfg, saved["ema"], 4), rtol=1e-6)
    assert abs(_val_loss(cfg, saved["params"], 4) - val[-1]["val/loss_simple"]) > 1e-6
    assert json.loads((logdir / "configs" / "run-config.json").read_text())["max_steps"] == 4
    tcli.main([str(cfg_path), "e1", "resume=true", "max_steps=5"])
    assert "resumed from step 4" in capsys.readouterr().out
    steps = [json.loads(line)["step"] for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert steps[-1] == 5


def test_ldm_cli_halts_on_non_finite(tmp_path):
    cfg = _tiny_cfg(tmp_path / "r", max_steps=3, validate=False, accumulate_grad_batches=1)
    cfg["model"] = {**cfg["model"], "base_learning_rate": 1e30}  # step 1 blows the params up
    with pytest.raises(FloatingPointError):
        tcli.run(cfg, "nan")
    assert CheckpointManager(tmp_path / "r" / "nan" / "checkpoints").all_steps()["rolling"] == [2]


UNPORTED = ["model.first_stage={type: kl}", "model.cond_stage={type: kl}", "model.scale_by_std=true",
            "init_from=x", "ckpt_path=x.ckpt", "model.remat=true", "dataset.kind=lsun",
            "model.unet_config.params.context_dim=16", "model.unet_config.params.num_classes=3", "profile_steps=2"]


@pytest.mark.parametrize("override", UNPORTED, ids=[o.split("=")[0] for o in UNPORTED])
def test_ldm_cli_rejects_unported(tmp_path, override, capsys):
    """Every key of the list is ported now.  `dataset.kind=lsun` without a
    `category` or `txt_file` raises KeyError.  The latent keys
    (tests/test_torch_latent_train.py trains that route): a first stage that
    cannot encode the 2-channel [prev slice, mask] condition raises
    ValueError before any step, and `cond_stage` or `scale_by_std` without a
    first stage leave the pixel route to train, as in the JAX CLI.
    `init_from` warm-starts from a port checkpoint, `ckpt_path` is not read
    (as the JAX CLI reads none), `model.remat` and a `context_dim` UNet
    train (the synthetic slices carry no context: attn2 attends over x),
    `num_classes` without class ids in the data raises ValueError naming `y`
    (the JAX UNet's assert), `profile_steps` writes a trace."""
    cfg = apply_overrides(_tiny_cfg(tmp_path / "x"), [override])
    key = override.split("=")[0]
    one = {"max_steps": 1, "validate": False}
    if key == "init_from":
        src = build_slice_ldm(cfg["model"], "cpu", seed=5, learn_logvar=True)
        torch.save({"params": {n: p.detach() for n, p in src.named_parameters()}}, tmp_path / "init.pt")
        cfg["init_from"] = str(tmp_path / "init.pt")
        n = len(src.named_parameters())
        assert tcli.run({**cfg, **one, "accumulate_grad_batches": 1}, "init").step == 1
        assert f"init_from: restored {n}/{n} leaves" in capsys.readouterr().out
        return
    if key == "model.first_stage":
        with pytest.raises(ValueError, match="in_channels=1 but the \\[prev slice, mask\\] condition is 2-channel"):
            tcli.run(cfg, "bad")
    elif key in ("model.cond_stage", "model.scale_by_std"):
        assert tcli.run({**cfg, "max_steps": 1, "validate": False}, "pixel").step == 1
    elif key == "dataset.kind":  # the stock kinds are ported (tests/test_torch_stock_data.py trains them):
        with pytest.raises(KeyError, match="category"):  # an lsun config names its category or txt_file
            tcli.run(cfg, "bad")
    elif key == "model.unet_config.params.num_classes":
        with pytest.raises(ValueError, match="class ids `y`"):
            tcli.run({**cfg, **one}, "adm")
    elif key == "profile_steps":
        assert tcli.run({**cfg, "max_steps": 2, "validate": False}, "prof").step == 2
        assert list((tmp_path / "x" / "prof" / "profile").glob("trace_step*.json"))
        assert "profiler: 2-step trace" in capsys.readouterr().out
    else:  # ckpt_path, model.remat, context_dim
        assert tcli.run({**cfg, **one}, "ok").step == 1


def test_ldm_cli_needs_a_device_on_a_cuda_less_machine(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    cfg = _tiny_cfg(tmp_path / "d")
    del cfg["device"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.run(cfg, "nodev")
