"""PyTorch port: the latent `_ae` route against the JAX package on the CPU.

`LatentSliceLDM` with tiny KL-VAE first and cond stages (a placed 'vanilla'
attention site and the mid one, `proj_out` non-zero) around a tiny UNet,
16x16 pixel slices, 8x8x4 latents, the JAX weights carried over and the JAX
draws replayed (`ReplayNoise`).  Tolerances: fp32 volumes within 1e-4 (the
min-max normalised [0, 1] slices; UNet and AEs sum in another order at every
step and slice); the bf16-UNet volume within BF16_TOL of the JAX fp32 one
(see there); encode / decode and the tiled versions within 1e-5 of their max;
stream_volume equals sample_volume bit for bit.

The volumes' JAX reference runs flax's GroupNorm with the two-pass variance
E[(x - E[x])^2], the port's formula, in place of its default one-pass E[x^2] -
E[x]^2 (`two_pass_group_norm`).  Guidance encodes the zeroed condition, a
near-constant field whose mean dwarfs its spread; there the one-pass formula
cancels most of its digits, and the JAX encoding is 4.5e-4 of its max off a
float64 one where the port's is 1.0e-6 off
(`test_zero_condition_encoding_against_float64`).
Nothing else differs."""

import contextlib
import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.diffusion.ddim import DDIMParams as TDDIM
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models.autoencoder import AutoencoderKL as TKL
from jointimagegeneration_torch.models.autoencoder import VQModel as TVQ
from jointimagegeneration_torch.models.latent_ldm import LatentSliceLDM as TLatent
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.pipeline.two_stage import TwoStagePipeline as TPipe
from jointimagegeneration_torch.pipeline.two_stage import make_chunked_two_stage_programs
from jointimagegeneration_torch.utils.jax_weights import ae_state_dict_from_jax
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams
from jointimagegeneration_tpu.models.autoencoder import AutoencoderKL, VQModel
from jointimagegeneration_tpu.models.latent_ldm import LatentSliceLDM
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler
from jointimagegeneration_tpu.pipeline.two_stage import TwoStagePipeline

from test_torch_weights import (ReplayNoise, assert_close_scaled, init_flax, jax_mask_draws, jax_volume_draws,
                                load_port, to_numpy, to_torch)

UNET = dict(model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
            num_head_channels=4)
AE = dict(embed_dim=4, ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), z_channels=4, resolution=16)
# the cond stage at ch 64, so that its GroupNorm groups hold two channels, as
# the configs' (ch 96 and 128, 32 groups) hold three or four: with one channel
# a group, guidance's encoding of the zeroed condition normalises a constant
# field in its first GroupNorm, where either framework divides its rounding
# residue by sqrt(1e-6) (the two encodings then differ by 3e-3 of their max)
COND_CH = 64
SF = 0.8
FP32_TOL = 1e-4
# bf16 UNet against the JAX fp32 one: the bf16 torso rounds every activation
# to 8 bits of mantissa, and each of the 3 steps of 2 slices feeds the next
# through the fp32 decode and the min-max normalisation; the [0, 1] slices
# differ by about 1e-2 (9.3e-3 measured), held within three times that
BF16_TOL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ae_pair(cin, seed, ch=AE["ch"]):
    jm = AutoencoderKL(in_channels=cin, out_ch=cin, **{**AE, "ch": ch})
    p = init_flax(jm, jnp.zeros((1, 16, 16, cin)), seed=seed)
    tm = TKL(in_channels=cin, out_ch=cin, device="cpu", **{**AE, "ch": ch})
    tm.load_state_dict(ae_state_dict_from_jax(p))
    return jm, {"params": p}, tm.eval()


def _latent_pair(dtype=torch.float32):
    jae, pae, tae = _ae_pair(1, 10)
    jcae, pcae, tcae = _ae_pair(2, 11, COND_CH)
    kw = dict(image_channels=4, cond_channels=4, timesteps=100, **UNET)
    jl = LatentSliceLDM.create(first_stage=jae, cond_stage=jcae, scale_factor=SF, **kw)
    pu = init_flax(jl.inner.unet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), cond=jnp.zeros((1, 8, 8, 4)), seed=12)
    ts = TSlice.create(device="cpu", dtype=dtype, **kw)
    load_port(ts.unet, pu)
    tl = TLatent(inner=ts, first_stage=tae, cond_stage=tcae, scale_factor=SF)
    return jl, ({"params": pu}, pae, pcae), tl  # the JAX model in fp32 whatever the port's dtype


@pytest.fixture(scope="module")
def latent_pair():
    return _latent_pair()


class GroupNorm(flax.linen.GroupNorm):  # the flax name, so the parameter paths stay `GroupNorm_0`
    use_fast_variance: bool = False


@contextlib.contextmanager
def two_pass_group_norm():
    """flax's GroupNorm with the two-pass variance, for the JAX reference."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "GroupNorm", GroupNorm)
        yield


def _ddims(jl, tl, steps=3, method="uniform_lambda"):
    return DDIMParams.create(jl.diffusion, steps, method=method), TDDIM.create(tl.diffusion, steps, method=method)


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _volumes(jl, params, tl, key, mask, **kw):
    jdd, tdd = _ddims(jl, tl)
    pu, pae, pcae = params
    with two_pass_group_norm():  # one jitted program: the eager first slice of warm start compiles op by op
        want = np.asarray(jax.jit(lambda pu, pae, pcae, key, m: jl.sample_volume(
            pu, pae, key, m, jdd, cond_ae_params=pcae, **kw))(pu, pae, pcae, key, jnp.asarray(mask)))
    noise = ReplayNoise(jax_volume_draws(key, mask.shape[0], mask.shape[1], 8, 8, 4))
    got = to_numpy(tl.sample_volume(noise, to_torch(mask), tdd, **kw))
    assert not noise.draws
    return got, want


@pytest.mark.parametrize("guidance_scale", [1.0, 2.0])
@pytest.mark.parametrize("warm_start", [None, 0.5])
@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_sample_volume_matches_jax(latent_pair, sampler, warm_start, guidance_scale):
    """Per slice: the cond-stage mode of [prev | mask], the latent chain, the
    first-stage decode, min-max; under guidance the uncond branch is the
    encoded zero condition, under warm start the raw latent is q-noised."""
    jl, params, tl = latent_pair
    mask = _rand(1, 1, 2, 16, 16, 1)
    got, want = _volumes(jl, params, tl, jax.random.key(3), mask, sampler=sampler, warm_start=warm_start,
                         guidance_scale=guidance_scale)
    assert got.shape == want.shape == (1, 2, 16, 16, 1)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)


def test_sample_volume_bf16_unet_matches_jax_fp32():
    jl, params, tl = _latent_pair(torch.bfloat16)
    assert tl.unet.dtype == torch.bfloat16 and tl.first_stage.encoder.conv_in.weight.dtype == torch.float32
    got, want = _volumes(jl, params, tl, jax.random.key(4), _rand(2, 1, 2, 16, 16, 1), sampler="dpm",
                         guidance_scale=2.0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)


def test_zero_condition_encoding_against_float64(latent_pair):
    """The encoding of the zeroed condition (guidance's uncond branch) against
    the same network in float64, as a fraction of its max: the port within
    1e-5 (1.0e-6 measured), the JAX package with the two-pass variance within
    1e-4 (3.8e-5), with its default one-pass variance ten times further off
    (4.5e-4)."""
    jl, (_, _, pcae), tl = latent_pair
    zeros = np.zeros((1, 16, 16, 2), np.float32)
    with torch.no_grad():
        exact = copy.deepcopy(tl.cond_stage).double().encode(torch.zeros((1, 16, 16, 2), dtype=torch.float64)).mode()
    exact = exact.numpy()
    port = to_numpy(tl.encode_cond(to_torch(zeros)))
    one_pass = np.asarray(jl.encode_cond(pcae, jnp.asarray(zeros)))
    with two_pass_group_norm():
        two_pass = np.asarray(jl.encode_cond(pcae, jnp.asarray(zeros)))
    err = lambda a: float(np.abs(a - exact).max() / np.abs(exact).max())  # noqa: E731
    assert err(port) <= 1e-5 and err(two_pass) <= 1e-4
    assert err(one_pass) > 5 * err(two_pass)


def test_stream_volume_equals_sample_volume(latent_pair):
    _, _, tl = latent_pair
    tdd = TDDIM.create(tl.diffusion, 3, method="uniform_lambda")
    mask, init = to_torch(_rand(5, 2, 3, 16, 16, 1)), to_torch(_rand(6, 2, 16, 16, 1))
    kw = dict(sampler="dpm", warm_start=0.5, guidance_scale=2.0, init_slice=init)
    whole = tl.sample_volume(NoiseSource(7, "cpu"), mask, tdd, **kw)
    streamed = torch.stack(list(tl.stream_volume(NoiseSource(7, "cpu"), mask, tdd, **kw)), dim=1)
    assert torch.equal(whole, streamed) and whole.shape == (2, 3, 16, 16, 1)


def test_encode_decode_and_tiled_match_jax(latent_pair):
    jl, (_, pae, pcae), tl = latent_pair
    x = _rand(8, 2, 24, 24, 1)
    key = jax.random.key(13)
    want = jax.jit(lambda pae, pcae, x, c, key: (  # one program, not op-by-op dispatch
        jl.encode(pae, x), jl.decode(pae, jl.encode(pae, x)), jl.encode_cond(pcae, c),
        jl.encode_tiled(pae, x, (16, 16), (8, 8)), jl.decode_tiled(pae, jl.encode_tiled(pae, x, (16, 16), (8, 8)),
                                                                   (8, 8), (4, 4)),
        jl.encode(pae, x, key)))
    c = _rand(9, 1, 16, 16, 2)
    z_j, dec_j, c_j, zt_j, dt_j, zs_j = want(pae, pcae, jnp.asarray(x), jnp.asarray(c), key)
    z_t = tl.encode(to_torch(x))
    assert_close_scaled(to_numpy(z_t), np.asarray(z_j), 1e-5)
    assert_close_scaled(to_numpy(tl.decode(z_t)), np.asarray(dec_j), 1e-5)
    assert_close_scaled(to_numpy(tl.encode_cond(to_torch(c))), np.asarray(c_j), 1e-5)
    zt_t = tl.encode_tiled(to_torch(x), (16, 16), (8, 8))
    assert zt_t.shape == (2, 12, 12, 4)
    assert_close_scaled(to_numpy(zt_t), np.asarray(zt_j), 1e-5)
    dt_t = tl.decode_tiled(zt_t, (8, 8), (4, 4))
    assert dt_t.shape == (2, 24, 24, 1)
    assert_close_scaled(to_numpy(dt_t), np.asarray(dt_j), 1e-5)
    # the posterior sample from given noise, scaled
    eps = np.asarray(jax.random.normal(key, (2, 12, 12, 4)))
    assert_close_scaled(to_numpy(tl.encode(to_torch(x), ReplayNoise([("normal", eps)]))), np.asarray(zs_j), 1e-5)


def test_calibrate_scale_factor_and_quantize_fn(latent_pair):
    jl, (_, pae, _), tl = latent_pair
    x = _rand(14, 3, 16, 16, 1)
    cal_j, cal_t = jl.calibrate_scale_factor(pae, jnp.asarray(x)), tl.calibrate_scale_factor(to_torch(x))
    np.testing.assert_allclose(cal_t.scale_factor, cal_j.scale_factor, rtol=1e-5)
    assert tl.scale_factor == SF and tl.make_quantize_fn() is None
    # a VQ first stage snaps pred_x0 to the codebook in the unscaled space
    vq = dict(embed_dim=3, n_embed=8, ch=8, ch_mult=(1, 2), num_res_blocks=1, z_channels=2, resolution=16)
    jvq = VQModel(**vq)
    p = init_flax(jvq, jnp.zeros((1, 16, 16, 1)))
    tvq = TVQ(device="cpu", **vq)
    tvq.load_state_dict(ae_state_dict_from_jax(p))
    jlv = LatentSliceLDM(inner=jl.inner, first_stage=jvq, scale_factor=0.5)
    tlv = TLatent(inner=tl.inner, first_stage=tvq, scale_factor=0.5)
    x0 = np.random.RandomState(15).randn(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(jlv.make_quantize_fn({"params": p})(jnp.asarray(x0)))
    np.testing.assert_allclose(to_numpy(tlv.make_quantize_fn()(to_torch(x0))), want, atol=1e-6)
    np.testing.assert_allclose(to_numpy(tlv.encode(to_torch(x))), np.asarray(jlv.encode({"params": p}, jnp.asarray(x))),
                               atol=1e-5)
    z = to_torch(x0)
    assert_close_scaled(to_numpy(tlv.decode(z)), np.asarray(jlv.decode({"params": p}, jnp.asarray(x0))), 1e-5)


def test_sample_slice_decodes_and_keeps_latent_rows(latent_pair):
    _, _, tl = latent_pair
    tdd = TDDIM.create(tl.diffusion, 4)
    cond = to_torch(_rand(16, 1, 16, 16, 2))
    x, rows = tl.sample_slice(NoiseSource(1, "cpu"), cond, tdd, return_intermediates=True)
    assert x.shape == (1, 16, 16, 1) and rows.shape == (4, 1, 8, 8, 4)
    z = tl.inner.sample_slice(NoiseSource(1, "cpu"), tl.encode_cond(cond), tdd)
    assert torch.equal(tl.sample_slice(NoiseSource(1, "cpu"), cond, tdd), tl.decode(z))


# ------------------------------------------------------ the latent pipeline --

MASK_SHAPE, VOLUME = (1, 4, 8, 8), (4, 16, 16)


def test_latent_two_stage_and_chunked_match_jax(latent_pair):
    jl, (pu, pae, pcae), tl = latent_pair
    jm = MaskSampler.create(num_classes=4, time_steps=20, **UNET)
    pm = init_flax(jm.unet, jnp.zeros((*MASK_SHAPE, 4)), jnp.zeros((1,)), cond=jnp.zeros((*MASK_SHAPE, 1)))
    tm = TMask.create(num_classes=4, time_steps=20, cond_channels=1, device="cpu", **UNET)
    load_port(tm.unet, pm)
    key = jax.random.key(21)
    cond = np.zeros((*MASK_SHAPE, 1), np.float32)
    jdd, tdd = _ddims(jl, tl)
    ct_j, lab_j = TwoStagePipeline(jm, jl)({"params": pm}, pu, key, mask_shape=MASK_SHAPE, volume_shape=VOLUME,
                                           ddim=jdd, mask_steps=3, cond=jnp.asarray(cond), ae_params=pae,
                                           cond_ae_params=pcae)
    k1, k2 = jax.random.split(key)
    noise = ReplayNoise(jax_mask_draws(k1, MASK_SHAPE, 4, 3) + jax_volume_draws(k2, 1, VOLUME[0], 8, 8, 4))
    tpipe = TPipe(tm, tl)
    ct_t, lab_t = tpipe(noise, mask_shape=MASK_SHAPE, volume_shape=VOLUME, ddim=tdd, mask_steps=3,
                        cond=torch.from_numpy(cond))
    assert not noise.draws and ct_t.shape == (1, *VOLUME, 1)
    assert np.mean(lab_t.numpy() == np.asarray(lab_j)) >= 0.999 and len(np.unique(np.asarray(lab_j))) > 1
    np.testing.assert_allclose(to_numpy(ct_t), np.asarray(ct_j), atol=FP32_TOL, rtol=0)
    # the chunked programs: two chunks of 2, the second seeded with the first's last pixel slice
    ct, labels = tpipe(NoiseSource(9, "cpu"), mask_shape=MASK_SHAPE, volume_shape=VOLUME, ddim=tdd, mask_steps=3,
                       cond=torch.from_numpy(cond))
    mask_program, chunk_program = make_chunked_two_stage_programs(
        tm, tl, mask_shape=MASK_SHAPE, volume_shape=VOLUME, ddim=tdd, chunk=2, mask_steps=3,
        cond=torch.from_numpy(cond))
    noise = NoiseSource(9, "cpu")
    labels_c, mask_channel = mask_program(noise)
    v0, last = chunk_program(noise, mask_channel[:, :2], None)
    assert last.shape == (1, 16, 16, 1)
    v1, _ = chunk_program(noise, mask_channel[:, 2:], last)
    assert torch.equal(labels_c, labels) and torch.equal(torch.cat([v0, v1], dim=1), ct)
    with pytest.raises(ValueError, match="first-stage"):
        TPipe(tm, TLatent(inner=tl.inner, first_stage=None))
    with pytest.raises(ValueError, match="first-stage"):
        make_chunked_two_stage_programs(tm, TLatent(inner=tl.inner, first_stage=None), mask_shape=MASK_SHAPE,
                                        volume_shape=VOLUME, ddim=tdd, chunk=2)
