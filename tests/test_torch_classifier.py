"""PyTorch port: the noisy-latent classifier (`models/classifier.py`) against
the JAX package's, on the CPU.

The logits, `loss` and `acc` under the JAX draws replayed (t, then the noise:
the JAX keys `kt, kn`), and `guidance_fn`'s gradient against `jax.grad`,
within 1e-5 of the output's scale (fp32; the frameworks sum in another
order).  Then a classifier-guided DDIM chain of a tiny SliceLDM against the
JAX `sample_slice(guidance_fn=...)` with the JAX draws replayed, within 2e-4
(the chain's tolerance in test_torch_sampler_routes.py: both UNets sum in
another order at every step), run under `torch.inference_mode()` too (the
guidance gradient leaves inference mode itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.diffusion.ddim import DDIMParams as TDDIM
from jointimagegeneration_torch.diffusion.gaussian import GaussianDiffusion as TGauss
from jointimagegeneration_torch.models.classifier import NoisyLatentClassifier as TClassifier
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.utils.jax_weights import unet_state_dict_from_jax
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams
from jointimagegeneration_tpu.diffusion.gaussian import GaussianDiffusion
from jointimagegeneration_tpu.models.classifier import NoisyLatentClassifier
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM

from test_torch_weights import ReplayNoise, init_flax, jax_slice_draws, load_port, to_numpy, to_torch

T = 100
NET = dict(model_channels=8, channel_mult=(1, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, frac=1e-5):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    jd = GaussianDiffusion.create("linear", T, linear_start=0.0015, linear_end=0.0195)
    jc = NoisyLatentClassifier.create(4, jd, **NET)
    p = init_flax(jc.net, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)))
    tc = TClassifier.create(4, TGauss.create("linear", T, linear_start=0.0015, linear_end=0.0195), in_channels=1,
                            device="cpu", **NET)
    state = unet_state_dict_from_jax(p)
    assert sorted(state) == sorted(tc.net.state_dict())
    tc.net.load_state_dict(state)
    return jc, {"params": p}, tc


def test_logits_match_jax(pair):
    jc, p, tc = pair
    x = np.random.RandomState(0).randn(3, 16, 16, 1).astype(np.float32)
    t = np.array([0.0, 40.0, 99.0], np.float32)
    want = np.asarray(jax.jit(jc.net.apply)(p, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = to_numpy(tc.net(to_torch(x), to_torch(t)))
    assert got.shape == (3, 4)
    _close(got, want)


def test_loss_and_acc_match_jax_under_replayed_draws(pair):
    jc, p, tc = pair
    x0 = np.random.RandomState(1).rand(4, 16, 16, 1).astype(np.float32)
    labels = np.array([0, 3, 1, 3], np.int32)
    key = jax.random.key(5)
    jloss, jm = jax.jit(jc.loss)(p, key, jnp.asarray(x0), jnp.asarray(labels))
    kt, kn = jax.random.split(key)
    draws = [("randint", np.asarray(jax.random.randint(kt, (4,), 0, T))),
             ("normal", np.asarray(jax.random.normal(kn, x0.shape)))]
    noise = ReplayNoise(draws)
    loss, m = tc.loss(noise, to_torch(x0), torch.from_numpy(labels))
    assert not noise.draws
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    (g,) = torch.autograd.grad(loss, [tc.net.in_conv.weight])  # the loss trains the classifier
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0


@pytest.mark.parametrize("scale", [1.0, 3.5])
def test_guidance_gradient_matches_jax_grad(pair, scale):
    jc, p, tc = pair
    x = np.random.RandomState(2).randn(2, 16, 16, 1).astype(np.float32)
    t = np.array([17, 80], np.int32)
    want = np.asarray(jax.jit(jc.guidance_fn(p, 2, scale))(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():  # a sampler's context: the function enables grad itself
        got = tc.guidance_fn(2, scale)(to_torch(x), torch.from_numpy(t.astype(np.int64)))
    assert got.shape == x.shape and not got.requires_grad
    _close(to_numpy(got), want)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_guided_ddim_chain_matches_jax(pair, mode):
    jc, p, tc = pair
    unet = dict(model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
                num_head_channels=4)
    js = SliceLDM.create(timesteps=T, **unet)
    up = init_flax(js.unet, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, 16, 16, 2)))
    ts = TSlice.create(timesteps=T, device="cpu", **unet)
    load_port(ts.unet, up)
    jddim, tddim = DDIMParams.create(js.diffusion, 5), TDDIM.create(ts.diffusion, 5)
    cond = np.random.RandomState(3).rand(2, 16, 16, 2).astype(np.float32)
    key = jax.random.key(9)
    want = np.asarray(js.sample_slice({"params": up}, key, jnp.asarray(cond), jddim,
                                      guidance_fn=jc.guidance_fn(p, 1, 40.0)))
    unguided = np.asarray(js.sample_slice({"params": up}, key, jnp.asarray(cond), jddim))
    noise = ReplayNoise(jax_slice_draws(key, (2, 16, 16, 1), 5))
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx:
        got = to_numpy(ts.sample_slice(noise, to_torch(cond), tddim, guidance_fn=tc.guidance_fn(1, 40.0)))
    assert not noise.draws  # guidance draws nothing
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    assert np.abs(want - unguided).max() > 1e-2  # the guidance moved the chain
