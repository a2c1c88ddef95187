"""PyTorch port: the stage-2 sampler routes against the JAX package on the CPU.

DPM-Solver++(2M) and PLMS, warm start, classifier-free guidance, inpainting,
patch tiling, the full-T ancestral loops, streaming and `log_images`, each
held against its JAX counterpart with the same numpy-seeded weights and
inputs and the JAX draws replayed through the port's noise interface
(`ReplayNoise`).  Tolerances: the multistep loops with an analytic eps
within 1e-5; fp32 chains through the tiny UNet within 2e-4 (the UNet sums in
another order at every step; the min-max normalised volumes, as in
test_torch_samplers.py); tiling with a closed-form fn, `_to_eps` and the
q_sample diffusion row within 1e-6; bf16 volumes within BF16_TOL (see
there); border weights, schedules, writers and indices exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.diffusion.ddim import DDIMParams as TDDIM
from jointimagegeneration_torch.diffusion.dpm_solver import dpm_solver_sample_loop as t_dpm
from jointimagegeneration_torch.diffusion.gaussian import GaussianDiffusion as TGauss
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.diffusion.plms import plms_sample_loop as t_plms
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.ops import tiling as ttile
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams
from jointimagegeneration_tpu.diffusion.dpm_solver import dpm_solver_sample_loop
from jointimagegeneration_tpu.diffusion.gaussian import GaussianDiffusion
from jointimagegeneration_tpu.diffusion.plms import plms_sample_loop
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM
from jointimagegeneration_tpu.ops import tiling as jtile

from test_torch_weights import (ReplayNoise, init_flax, jax_ancestral_draws, jax_log_images_draws,
                                jax_slice_draws, jax_volume_draws, load_port, to_numpy, to_torch)

UNET = dict(model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
            num_head_channels=4)
FP32_TOL = 2e-4
# bf16 volume: both UNets round every activation to bf16 (8 bits of
# mantissa, an ulp of 2^-8 at 1), in another order, and each of the 5 steps of
# 3 slices feeds the next; the min-max normalised [0, 1] slices differ by
# about two ulps at 1 (7.3e-3 measured), held within five
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests: the tiny models gain
    nothing from more, and the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype=torch.float32, timesteps=100, size=16, **kw):
    """(JAX SliceLDM, its params, port SliceLDM with the same weights)."""
    js = SliceLDM.create(timesteps=timesteps, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32,
                         **UNET, **kw)
    p = init_flax(js.unet, jnp.zeros((1, size, size, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, size, size, 2)))
    ts = TSlice.create(timesteps=timesteps, dtype=dtype, device="cpu", **UNET, **kw)
    load_port(ts.unet, p)
    return js, {"params": p}, ts


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _ddims(js, ts, steps=5, method="uniform_lambda", eta=0.0):
    return (DDIMParams.create(js.diffusion, steps, method=method, eta=eta),
            TDDIM.create(ts.diffusion, steps, method=method, eta=eta))


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# ------------------------------------------------------ the multistep loops --

def _eps_jax(x, t):
    return jnp.tanh(x) * (0.5 + t.astype(jnp.float32) / 2000)[:, None, None, None] + 0.1 * jnp.sin(3 * x)


def _eps_torch(x, t):
    return torch.tanh(x) * (0.5 + t.float() / 2000)[:, None, None, None] + 0.1 * torch.sin(3 * x)


@pytest.mark.parametrize("start_index", [None, 1, 8, 20])
@pytest.mark.parametrize("loop", ["dpm", "plms"])
def test_multistep_loops_match_jax(loop, start_index):
    """S = 20 uniform-lambda nodes at T = 1000, an analytic eps, within 1e-5."""
    jd = GaussianDiffusion.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    td = TGauss.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    jp, tp = DDIMParams.create(jd, 20, method="uniform_lambda"), TDDIM.create(td, 20, method="uniform_lambda")
    x_T = np.random.RandomState(0).randn(2, 4, 4, 1).astype(np.float32)
    jloop, tloop = {"dpm": (dpm_solver_sample_loop, t_dpm), "plms": (plms_sample_loop, t_plms)}[loop]
    calls = []
    want = np.asarray(jloop(_eps_jax, jp, jnp.asarray(x_T), start_index=start_index))
    got = to_numpy(tloop(lambda x, t: calls.append(t) or _eps_torch(x, t), tp, to_torch(x_T),
                         start_index=start_index))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    k = 20 if start_index is None else start_index
    assert len(calls) == k + (loop == "plms")  # PLMS's first step is Heun: a second call
    assert [int(t[0]) for t in calls[:1]] == [int(tp.timesteps[k - 1])]
    with pytest.raises(ValueError):
        tloop(_eps_torch, tp, to_torch(x_T), start_index=21)


# ------------------------------------------------------------- the volume --

@pytest.mark.parametrize("guidance_scale", [1.0, 2.0])
@pytest.mark.parametrize("warm_start", [None, 0.4])
@pytest.mark.parametrize("sampler", ["ddim", "plms", "dpm"])
def test_sample_volume_routes_match_jax(fp32_pair, sampler, warm_start, guidance_scale):
    js, p, ts = fp32_pair
    jdd, tdd = _ddims(js, ts)
    mask, init = _rand(1, 1, 3, 16, 16, 1), _rand(2, 1, 16, 16, 1)
    key = jax.random.key(3)
    kw = dict(sampler=sampler, warm_start=warm_start, guidance_scale=guidance_scale)
    want = np.asarray(js.sample_volume(p, key, jnp.asarray(mask), jdd, init_slice=jnp.asarray(init), **kw))
    noise = ReplayNoise(jax_volume_draws(key, 1, 3, 16, 16, 1))
    got = to_numpy(ts.sample_volume(noise, to_torch(mask), tdd, init_slice=to_torch(init), **kw))
    assert not noise.draws and got.shape == want.shape == (1, 3, 16, 16, 1)
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


def test_sample_volume_bf16_matches_jax():
    js, p, ts = _pair(torch.bfloat16)
    jdd, tdd = _ddims(js, ts)
    mask = _rand(4, 1, 3, 16, 16, 1)
    key = jax.random.key(4)
    kw = dict(sampler="dpm", warm_start=0.4, guidance_scale=2.0)
    want = np.asarray(js.sample_volume(p, key, jnp.asarray(mask), jdd, **kw))
    got = to_numpy(ts.sample_volume(ReplayNoise(jax_volume_draws(key, 1, 3, 16, 16, 1)), to_torch(mask), tdd, **kw))
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("sampler,guidance_scale,calls", [
    ("ddim", 1.0, 5), ("ddim", 2.0, 10), ("dpm", 1.0, 5), ("dpm", 2.0, 10), ("plms", 1.0, 6), ("plms", 2.0, 12)])
def test_guidance_scale_one_makes_one_call_a_step(fp32_pair, monkeypatch, sampler, guidance_scale, calls):
    _, _, ts = fp32_pair
    seen = []
    forward = ts.unet.forward
    monkeypatch.setattr(ts.unet, "forward", lambda x, t, cond=None: seen.append(cond.abs().sum() > 0)
                        or forward(x, t, cond=cond))
    dd = TDDIM.create(ts.diffusion, 5, method="uniform_lambda")
    ts.sample_volume(NoiseSource(0, "cpu"), to_torch(_rand(5, 1, 1, 16, 16, 1)), dd, sampler=sampler,
                     guidance_scale=guidance_scale, init_slice=to_torch(_rand(6, 1, 16, 16, 1)))
    assert len(seen) == calls
    # with guidance, each conditioned call is followed by one with the cond zeroed
    assert [bool(s) for s in seen] == ([True, False] * (calls // 2) if guidance_scale != 1.0 else [True] * calls)


def test_to_eps_x0_parameterization(fp32_pair):
    js, p, ts = _pair(parameterization="x0")
    rs = np.random.RandomState(7)
    out, x = rs.randn(3, 8, 8, 1).astype(np.float32), rs.randn(3, 8, 8, 1).astype(np.float32)
    t = np.array([1, 50, 99], np.int32)
    want = np.asarray(js._to_eps(jnp.asarray(out), jnp.asarray(x), jnp.asarray(t)))
    got = to_numpy(ts._to_eps(to_torch(out), to_torch(x), torch.tensor(t, dtype=torch.int64)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    eps_out = to_torch(out)
    assert fp32_pair[2]._to_eps(eps_out, to_torch(x), torch.tensor(t)) is eps_out  # an eps model's output as it is
    # and a whole DPM slice of the x0 model
    jdd, tdd = _ddims(js, ts)
    cond = _rand(8, 1, 16, 16, 2)
    key = jax.random.key(8)
    want = np.asarray(js.sample_slice_dpm(p, key, jnp.asarray(cond), jdd))
    got = to_numpy(ts.sample_slice_dpm(ReplayNoise(jax_slice_draws(key, (1, 16, 16, 1), 0)), to_torch(cond), tdd))
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


@pytest.mark.parametrize("region,eta,temperature", [("left", 0.0, 1.0), ("right", 0.0, 1.0), ("left", 0.5, 0.7)])
def test_inpaint_outpaint_and_intermediates_match_jax(fp32_pair, region, eta, temperature):
    """A mask of 1 keeps the input (inpaint: the left half of W; outpaint: the
    right half); the pred_x0 trajectory comes back as (S, B, H, W, C)."""
    js, p, ts = fp32_pair
    jdd, tdd = _ddims(js, ts, method="uniform", eta=eta)
    cond, x0 = _rand(9, 2, 16, 16, 2), _rand(10, 2, 16, 16, 1)
    mask = np.zeros_like(x0)
    mask[:, :, :8] = 1.0
    if region == "right":
        mask = 1.0 - mask
    key = jax.random.key(11)
    want, want_i = js.sample_slice(p, key, jnp.asarray(cond), jdd, inpaint_mask=jnp.asarray(mask),
                                   inpaint_x0=jnp.asarray(x0), return_intermediates=True, temperature=temperature)
    noise = ReplayNoise(jax_slice_draws(key, (2, 16, 16, 1), 5, inpaint=True, eta=eta > 0))
    got, got_i = ts.sample_slice(noise, to_torch(cond), tdd, inpaint_mask=to_torch(mask), inpaint_x0=to_torch(x0),
                                 return_intermediates=True, temperature=temperature)
    assert not noise.draws and got_i.shape == (5, 2, 16, 16, 1)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=FP32_TOL, rtol=0)
    np.testing.assert_allclose(to_numpy(got_i), np.asarray(want_i), atol=FP32_TOL, rtol=0)


# ----------------------------------------------------------------- tiling --

@pytest.mark.parametrize("hw", [(8, 8), (7, 10), (1, 5), (32, 32)])
def test_border_weighting_exact(hw):
    np.testing.assert_array_equal(ttile.border_weighting(hw), np.asarray(jtile.border_weighting(hw)))


def _fn_pair(out_scale):
    if out_scale == 2.0:
        return (lambda w: jnp.repeat(jnp.repeat(w, 2, 1), 2, 2) * 1.5,
                lambda w: w.repeat_interleave(2, 1).repeat_interleave(2, 2) * 1.5)
    if out_scale == 0.5:
        def j(w):
            b, h, ww, c = w.shape
            return w.reshape(b, h // 2, 2, ww // 2, 2, c).mean(axis=(2, 4))

        def t(w):
            b, h, ww, c = w.shape
            return w.reshape(b, h // 2, 2, ww // 2, 2, c).mean(dim=(2, 4))

        return j, t
    return (lambda w: w[..., :2] * 1.5 + jnp.sin(w[..., 1:3]), lambda w: w[..., :2] * 1.5 + torch.sin(w[..., 1:3]))


@pytest.mark.parametrize("size,patch,stride,out_scale", [
    ((16, 16), (8, 8), (4, 4), 1.0),
    ((21, 18), (8, 8), (6, 5), 1.0),  # ragged: the last offsets 13 and 10 are off the stride
    ((12, 12), (8, 8), (4, 4), 2.0),
    ((16, 16), (8, 8), (4, 4), 0.5),
])
def test_tiled_apply_matches_jax(size, patch, stride, out_scale):
    x = np.random.RandomState(12).randn(2, *size, 3).astype(np.float32)
    jfn, tfn = _fn_pair(out_scale)
    c_out = 2 if out_scale == 1.0 else None
    want = np.asarray(jtile.tiled_apply(jfn, jnp.asarray(x), patch, stride, out_channels=c_out, out_scale=out_scale))
    got = to_numpy(ttile.tiled_apply(tfn, to_torch(x), patch, stride, out_channels=c_out, out_scale=out_scale))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("guidance_scale", [1.0, 2.0])
def test_tiled_sample_slice_matches_jax(fp32_pair, guidance_scale):
    """24x24 slices in 16x16 windows at stride 8 (4 windows), [x | cond]
    moving together."""
    js, p, ts = fp32_pair
    jdd, tdd = _ddims(js, ts, method="uniform")
    cond = _rand(13, 1, 24, 24, 2)
    key = jax.random.key(13)
    tile = ((16, 16), (8, 8))
    want = np.asarray(js.sample_slice(p, key, jnp.asarray(cond), jdd, tile=tile, guidance_scale=guidance_scale))
    got = to_numpy(ts.sample_slice(ReplayNoise(jax_slice_draws(key, (1, 24, 24, 1), 5)), to_torch(cond), tdd,
                                   tile=tile, guidance_scale=guidance_scale))
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


# ------------------------------------------------------- the ancestral loops --

@pytest.fixture(scope="module")
def t20_pair():
    return _pair(timesteps=20)


@pytest.mark.parametrize("route", ["p_sample_loop", "p_sample_loop_rows", "progressive_denoising"])
def test_ancestral_loops_match_jax(t20_pair, route):
    """T = 20, clip_denoised, a quantize_fn, rows at every T // 6 = 3rd t
    (7 rows), in sampling order."""
    js, p, ts = t20_pair
    cond = _rand(14, 2, 16, 16, 2)
    key = jax.random.key(14)
    name = route.removesuffix("_rows")
    kw = {"return_intermediates": True} if route.endswith("_rows") else {"quantize_fn": lambda v: v * 0.5}
    want = getattr(js, name)(p, key, jnp.asarray(cond), **kw)
    noise = ReplayNoise(jax_ancestral_draws(key, (2, 16, 16, 1), 20))
    got = getattr(ts, name)(noise, to_torch(cond), **kw)
    assert not noise.draws
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=FP32_TOL, rtol=0)
    if route != "p_sample_loop":
        assert got[1].shape == (7, 2, 16, 16, 1)


# --------------------------------------------------------------- streaming --

@pytest.mark.parametrize("sampler", ["ddim", "plms", "dpm"])
def test_stream_volume_equals_sample_volume(fp32_pair, sampler):
    _, _, ts = fp32_pair
    dd = TDDIM.create(ts.diffusion, 5, method="uniform_lambda")
    mask = to_torch(_rand(15, 1, 3, 16, 16, 1))
    kw = dict(sampler=sampler, warm_start=0.4, guidance_scale=2.0)
    slices = list(ts.stream_volume(NoiseSource(5, "cpu"), mask, dd, **kw))
    assert len(slices) == 3
    assert torch.equal(torch.stack(slices, dim=1), ts.sample_volume(NoiseSource(5, "cpu"), mask, dd, **kw))


# ------------------------------------------------------------------- panels --

def test_log_images_match_jax(t20_pair):
    js, p, ts = t20_pair
    jdd, tdd = _ddims(js, ts, steps=4, method="uniform")
    batch = {"image": _rand(16, 2, 16, 16, 1), "cond": _rand(17, 2, 16, 16, 2)}
    key = jax.random.key(16)
    want = js.log_images(p, key, {k: jnp.asarray(v) for k, v in batch.items()}, jdd, progressive=True)
    noise = ReplayNoise(jax_log_images_draws(key, (2, 16, 16, 1), 4, 20, progressive=True))
    got = ts.log_images(noise, {k: to_torch(v) for k, v in batch.items()}, tdd, progressive=True)
    assert not noise.draws
    assert sorted(got) == sorted(want) == sorted(["inputs", "samples", "denoise_row", "diffusion_row", "inpaint",
                                                  "outpaint", "conditioning", "progressive_row"])
    shapes = {"denoise_row": (4, 2, 16, 16, 1), "diffusion_row": (6, 2, 16, 16, 1),
              "progressive_row": (7, 2, 16, 16, 1), "conditioning": (2, 16, 16, 2)}
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].shape == want[k].shape == shapes.get(k, (2, 16, 16, 1)), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-6 if k in ("inputs", "conditioning", "diffusion_row")
                                   else FP32_TOL, rtol=0, err_msg=k)


# ------------------------------------------------------------------ guards --

@pytest.mark.parametrize("sampler,tile,eta", [
    ("euler", None, 0.0), ("dpm", ((8, 8), (4, 4)), 0.0), ("plms", ((8, 8), (4, 4)), 0.0), ("plms", None, 0.5),
    ("dpm", None, 1.0)])
def test_check_sampler_raises(fp32_pair, sampler, tile, eta):
    js, _, ts = fp32_pair
    jdd, tdd = _ddims(js, ts, method="uniform", eta=eta)
    with pytest.raises(ValueError):
        SliceLDM._check_sampler(sampler, tile, jdd)
    with pytest.raises(ValueError):
        TSlice._check_sampler(sampler, tile, tdd)
    with pytest.raises(ValueError):
        ts.sample_volume(NoiseSource(0, "cpu"), torch.zeros(1, 1, 16, 16, 1), tdd, sampler=sampler, tile=tile)


@pytest.mark.parametrize("f", [None, 0.4, 0.01, 0.025, 0.125, 0.5, 1.0, 0.0, -0.1, 1.5])
def test_warm_start_index(f):
    """round() is Python's (0.125 * 20 = 2.5 -> 2), clamped to [1, S];
    ValueError outside (0, 1]."""
    jd = GaussianDiffusion.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    td = TGauss.create("linear", 1000, linear_start=0.0015, linear_end=0.0195)
    jp, tp = DDIMParams.create(jd, 20), TDDIM.create(td, 20)
    if f is not None and not 0.0 < f <= 1.0:
        with pytest.raises(ValueError):
            SliceLDM.warm_start_index(jp, f)
        with pytest.raises(ValueError):
            TSlice.warm_start_index(tp, f)
        return
    assert TSlice.warm_start_index(tp, f) == SliceLDM.warm_start_index(jp, f)
    assert TSlice.warm_start_index(tp, f) == {None: None, 0.4: 8, 0.01: 1, 0.025: 1, 0.125: 2, 0.5: 10, 1.0: 20}[f]
