"""PyTorch port: schedules, the categorical and DDIM samplers, and the handoff,
against the JAX package on the CPU.

Random draws are the JAX ones, replayed through the port's noise interface
(`ReplayNoise`).  Tolerances: schedule and DDIM arrays exact (the port copies
the float64 numpy code and stores float32 as the JAX package does); the
posterior within 1e-6 (fp32); sampled labels equal; the fp32 stage-2 volume
within 2e-4 (the UNet sums in another order each DDIM step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.diffusion import categorical as tcat
from jointimagegeneration_torch.diffusion.ddim import DDIMParams as TDDIM, ddim_step as t_ddim_step
from jointimagegeneration_torch.diffusion.gaussian import GaussianDiffusion as TGauss
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask, sampling_t_values as t_tvals
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.ops import schedules as tsched
from jointimagegeneration_torch.pipeline import two_stage as tpipe
from jointimagegeneration_tpu.diffusion.categorical import CategoricalDiffusion, brute_force_theta_post_prob
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams, ddim_step
from jointimagegeneration_tpu.diffusion.gaussian import GaussianDiffusion
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler, sampling_t_values
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM
from jointimagegeneration_tpu.ops import schedules as jsched
from jointimagegeneration_tpu.pipeline import two_stage as jpipe

from test_torch_weights import (ReplayNoise, init_flax, jax_mask_draws, jax_volume_draws, load_port,
                                to_numpy, to_torch)


@pytest.mark.parametrize("name,kw", [("cosine", {}), ("linear", {"start": 0.02, "end": 0.3})])
def test_categorical_schedules_copied(name, kw):
    a, b = tsched.make_categorical_schedule(name, 50, **kw), jsched.make_categorical_schedule(name, 50, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("method", ["uniform", "quad", "uniform_lambda"])
def test_gaussian_and_ddim_schedules_copied(method):
    betas = tsched.gaussian_beta_schedule("linear", 1000, 0.0015, 0.0195)
    np.testing.assert_array_equal(betas, jsched.gaussian_beta_schedule("linear", 1000, 0.0015, 0.0195))
    ac = np.cumprod(1 - betas)
    s_t = tsched.ddim_timestep_subset(method, 50, 1000, alphas_cumprod=ac)
    np.testing.assert_array_equal(s_t, jsched.ddim_timestep_subset(method, 50, 1000, alphas_cumprod=ac))
    for x, y in zip(tsched.ddim_sampling_parameters(ac, s_t, 0.5), jsched.ddim_sampling_parameters(ac, s_t, 0.5)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_theta_post_prob_and_t1_boundary(schedule):
    """Closed-form posterior equals the JAX one (and its brute-force O(C^2)
    contraction), with the t == 1 overrides, for a batch of t values."""
    c = 5
    jd = CategoricalDiffusion.create(schedule, 40, c)
    td = tcat.CategoricalDiffusion.create(schedule, 40, c, device="cpu")
    rs = np.random.RandomState(0)
    xt = np.eye(c, dtype=np.float32)[rs.randint(0, c, (4, 3, 3))]
    x0 = rs.dirichlet(np.ones(c), (4, 3, 3)).astype(np.float32)
    t = np.array([1, 2, 17, 40], np.int32)
    want = np.asarray(jd.theta_post_prob(jnp.asarray(xt), jnp.asarray(x0), jnp.asarray(t)))
    got = to_numpy(td.theta_post_prob(to_torch(xt), to_torch(x0), torch.tensor(t)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, brute_force_theta_post_prob(jd, xt, x0, t), rtol=1e-5, atol=1e-6)
    # t == 1: alphas -> 0 and cumalphas_prev -> 1, so the posterior is theta_x0 itself
    np.testing.assert_allclose(got[0], x0[0], rtol=1e-6, atol=1e-7)
    onehot = np.eye(c, dtype=np.float32)[rs.randint(0, c, (4, 3, 3))]
    np.testing.assert_allclose(to_numpy(td.theta_post(to_torch(xt), to_torch(onehot), torch.tensor(t))),
                               np.asarray(jd.theta_post(jnp.asarray(xt), jnp.asarray(onehot), jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,K", [(1000, 250), (1000, 4), (20, 20), (20, None), (7, 1)])
def test_sampling_t_values(T, K):
    np.testing.assert_array_equal(t_tvals(T, K), sampling_t_values(T, K))


def test_ddim_params_and_guards():
    jd = GaussianDiffusion.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    td = TGauss.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    np.testing.assert_array_equal(td.alphas_cumprod, np.asarray(jd.alphas_cumprod))
    for steps, method, eta in ((50, "uniform", 0.0), (20, "uniform_lambda", 0.0), (30, "quad", 0.7)):
        j, t = DDIMParams.create(jd, steps, method=method, eta=eta), TDDIM.create(td, steps, method=method, eta=eta)
        for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
            np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)), err_msg=f)
    for steps in (1000, 700):  # S == T; and a 'uniform' stride of 1 running past T
        with pytest.raises(ValueError):
            DDIMParams.create(jd, steps)
        with pytest.raises(ValueError):
            TDDIM.create(td, steps)


def test_ddim_step_matches_jax():
    jd = GaussianDiffusion.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    td = TGauss.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    jp, tp = DDIMParams.create(jd, 50), TDDIM.create(td, 50)
    rs = np.random.RandomState(1)
    x, e = rs.randn(2, 8, 8, 1).astype(np.float32), rs.randn(2, 8, 8, 1).astype(np.float32)
    for index in (49, 10, 0):
        jx, jx0 = ddim_step(jp, jax.random.key(0), jnp.asarray(x), jnp.asarray(e), index)
        tx, tx0 = t_ddim_step(tp, ReplayNoise([]), to_torch(x), to_torch(e), index)  # eta 0: no draw
        np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(to_numpy(tx0), np.asarray(jx0), rtol=1e-6, atol=1e-6)
    # eta > 0: the step draws one normal, scaled by sigma
    jp, tp = DDIMParams.create(jd, 50, eta=1.0), TDDIM.create(td, 50, eta=1.0)
    key = jax.random.key(3)
    jx, _ = ddim_step(jp, key, jnp.asarray(x), jnp.asarray(e), 20)
    n = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    tx, _ = t_ddim_step(tp, ReplayNoise([("normal", n)]), to_torch(x), to_torch(e), 20)
    np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=1e-6, atol=1e-6)


def _tiny_mask_models(step_T_sample="majority"):
    kw = dict(num_classes=4, time_steps=20, model_channels=8, channel_mult=(1, 2),
              attention_resolutions=(2,), num_res_blocks=1, num_head_channels=4)
    jm = MaskSampler.create(step_T_sample=step_T_sample, **kw)
    shape = (1, 4, 8, 8)
    p = init_flax(jm.unet, jnp.zeros((*shape, 4)), jnp.zeros((1,)), cond=jnp.zeros((*shape, 1)))
    tm = TMask.create(cond_channels=1, step_T_sample=step_T_sample, device="cpu", **kw)
    load_port(tm.unet, p)
    return jm, p, tm, shape


@pytest.mark.parametrize("rule", ["majority", "confidence"])
def test_mask_sampler_replayed_labels_equal(rule):
    jm, p, tm, shape = _tiny_mask_models(rule)
    cond = np.random.RandomState(2).rand(*shape, 1).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jm.sample_labels({"params": p}, key, shape, cond=jnp.asarray(cond), num_steps=4))
    noise = ReplayNoise(jax_mask_draws(key, shape, 4, 4))
    got = tm.sample_labels(noise, shape, cond=to_torch(cond), num_steps=4).numpy()
    assert not noise.draws and len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_slice_ldm_volume_replayed():
    kw = dict(timesteps=100, model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,),
              num_res_blocks=1, num_head_channels=4)
    js = SliceLDM.create(**kw)
    p = init_flax(js.unet, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, 16, 16, 2)))
    ts = TSlice.create(device="cpu", **kw)
    load_port(ts.unet, p)
    mask = np.random.RandomState(3).rand(1, 3, 16, 16, 1).astype(np.float32)
    init = np.random.RandomState(4).rand(1, 16, 16, 1).astype(np.float32)
    key = jax.random.key(5)
    jdd = DDIMParams.create(js.diffusion, 4)
    want = np.asarray(js.sample_volume({"params": p}, key, jnp.asarray(mask), jdd, init_slice=jnp.asarray(init)))
    noise = ReplayNoise(jax_volume_draws(key, 1, 3, 16, 16, 1))
    got = to_numpy(ts.sample_volume(noise, to_torch(mask), TDDIM.create(ts.diffusion, 4), init_slice=to_torch(init)))
    assert not noise.draws and got.shape == want.shape == (1, 3, 16, 16, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    # the routes beyond plain DDIM, each against JAX with the same draws
    for kw_opt in ({"warm_start": 0.5}, {"sampler": "dpm"}, {"guidance_scale": 2.0}, {"tile": ((8, 8), (4, 4))}):
        want = np.asarray(js.sample_volume({"params": p}, key, jnp.asarray(mask), jdd, init_slice=jnp.asarray(init),
                                           **kw_opt))
        noise = ReplayNoise(jax_volume_draws(key, 1, 3, 16, 16, 1))
        got = to_numpy(ts.sample_volume(noise, to_torch(mask), TDDIM.create(ts.diffusion, 4),
                                        init_slice=to_torch(init), **kw_opt))
        assert not noise.draws
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0, err_msg=str(kw_opt))


@pytest.mark.parametrize("src,dst", [((4, 6, 6), (6, 16, 16)), ((6, 8, 8), (9, 12, 12)), ((3, 4, 4), (6, 8, 8))])
def test_upsample_labels_matches_jax_nearest(src, dst):
    """Non-integer ratios included: 'nearest-exact' is jax.image.resize's
    'nearest'; torch's plain 'nearest' differs there."""
    labels = np.random.RandomState(6).randint(0, 12, (2, *src)).astype(np.int32)
    want = np.asarray(jpipe.upsample_labels(jnp.asarray(labels), dst))
    got = tpipe.upsample_labels(torch.tensor(labels, dtype=torch.int64), dst).numpy()
    np.testing.assert_array_equal(got, want)


def test_normalize_mask_channel():
    labels = np.arange(12, dtype=np.int32).reshape(1, 3, 2, 2)
    for c in (12, 1):
        want = np.asarray(jpipe.normalize_mask_channel(jnp.asarray(labels), c))
        got = tpipe.normalize_mask_channel(torch.tensor(labels), c).numpy()
        np.testing.assert_array_equal(got, want)
