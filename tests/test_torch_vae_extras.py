"""PyTorch port: the stock VAE extras against the JAX package on the CPU.

`SimpleDecoder`, `UpsampleDecoder`, `LatentRescaler` (nearest resize by 1.5,
2 and 3, where the source index floor((i + 0.5) n / out) lands on whole
numbers), `MergedRescaleEncoder`, `MergedRescaleDecoder` and `Upsampler` at
tiny widths, in 2D and 3D, with the JAX weights carried over by
`ae_state_dict_from_jax` (every leaf non-zero).  fp32, each output within
1e-5 of its max |JAX value|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.nn import vae as tvae
from jointimagegeneration_torch.utils.jax_weights import ae_state_dict_from_jax
from jointimagegeneration_tpu.nn import vae

from test_torch_weights import assert_close_scaled, init_flax, jax_apply, to_numpy, to_torch

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spatial(dims, size):
    return (size,) * 2 if dims == 2 else (4,) + (size,) * 2


def _case(name, dims):
    """(JAX module, port module, input shape without the batch)."""
    if name == "simple":
        return (vae.SimpleDecoder(out_channels=3, dims=dims), tvae.SimpleDecoder(4, 3, dims, device="cpu"),
                (*_spatial(dims, 6), 4))
    if name == "upsample":
        kw = dict(ch=4, num_res_blocks=1, ch_mult=(2, 1), dims=dims)
        return (vae.UpsampleDecoder(out_channels=2, **kw), tvae.UpsampleDecoder(3, 2, device="cpu", **kw),
                (*_spatial(dims, 6), 3))
    if name.startswith("rescaler"):
        factor = float(name.split("_")[1])
        return (vae.LatentRescaler(factor, 8, 3, depth=1, dims=dims),
                tvae.LatentRescaler(factor, 5, 8, 3, depth=1, dims=dims, device="cpu"), (*_spatial(dims, 4), 5))
    stack = dict(ch=4, num_res_blocks=1, attn_resolutions=(8,), ch_mult=(1, 2), resolution=16, dims=dims)
    if name == "merged_encoder":
        kw = dict(out_ch=3, rescale_factor=1.5, **stack)
        return (vae.MergedRescaleEncoder(in_ch=2, **kw), tvae.MergedRescaleEncoder(in_ch=2, device="cpu", **kw),
                (*_spatial(dims, 16), 2))
    if name == "merged_decoder":
        kw = dict(z_channels=3, out_ch=2, rescale_factor=2.0, **stack)
        return (vae.MergedRescaleDecoder(**kw), tvae.MergedRescaleDecoder(device="cpu", **kw),
                (*_spatial(dims, 4), 3))
    in_size, out_size = (4, 8) if name == "upsampler" else (4, 10)
    return (vae.Upsampler(in_size, out_size, 2, dims=dims),
            tvae.Upsampler(in_size, out_size, 3, 2, dims=dims, device="cpu"), (*_spatial(dims, in_size), 3))


CASES = ["simple", "upsample", "rescaler_1.5", "rescaler_2", "rescaler_3", "merged_encoder", "merged_decoder",
         "upsampler", "upsampler_ragged"]


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("name", CASES)
def test_extra_matches_jax(name, dims):
    jm, tm, shape = _case(name, dims)
    x = np.random.RandomState(len(name) + dims).randn(2, *shape).astype(np.float32)
    p = init_flax(jm, jnp.zeros((1, *shape)))
    want = np.asarray(jax_apply(jm, p, jnp.asarray(x)))
    tm.load_state_dict(ae_state_dict_from_jax(p))
    with torch.no_grad():
        got = to_numpy(tm.eval()(to_torch(x)))
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    assert_close_scaled(got, want, TOL)


def test_rescaler_sizes_and_the_upsampler_guard():
    """round(n * factor) per axis (4 * 1.5 = 6, 5 * 1.5 = 7.5 -> 8 by
    Python's round); the Upsampler refuses to shrink."""
    m = tvae.LatentRescaler(1.5, 2, 4, 2, depth=0, device="cpu")
    with torch.no_grad():
        assert m(torch.randn(1, 4, 5, 2)).shape == (1, 6, 8, 2)
    with pytest.raises(ValueError, match="out_size"):
        tvae.Upsampler(8, 4, 3, 1, device="cpu")
