"""PyTorch port: UNet building blocks against the JAX package's, on the CPU.

Same inputs (numpy, seeded) and the same weights (through the bridge, every
kernel non-zero) go through both.  Tolerances: fp32 within 1e-5 relative
(elementwise, plus 1e-5 of the output scale absolute: the convolutions sum in
another order); bf16 within 3e-2 of the output scale (bf16 rounds at other
places in the two frameworks)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.nn import blocks as tb
from jointimagegeneration_tpu.nn import blocks as jb

from test_torch_weights import assert_close_scaled, init_flax, jax_apply, load_port, to_numpy, to_torch

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def check(got, want, dtype_name):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = to_numpy(got)
    assert got.shape == want.shape
    if dtype_name == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        assert_close_scaled(got, want, 3e-2)


def test_timestep_embedding():
    t = np.array([0.0, 1.0, 17.0, 500.0, 999.0], np.float32)
    for dim in (32, 33):
        want = np.asarray(jb.timestep_embedding(jnp.asarray(t), dim))
        np.testing.assert_allclose(to_numpy(tb.timestep_embedding(to_torch(t), dim)), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_groupnorm32(dt):
    jdt, tdt = DTYPES[dt]
    x = np.random.RandomState(0).randn(2, 6, 5, 48).astype(np.float32) * 3 + 1
    m = jb.GroupNorm32()
    p = init_flax(m, jnp.asarray(x))
    want = jax_apply(m, p, jnp.asarray(x, jdt))
    port = load_port(tb.GroupNorm32(48), p)
    assert port.groups == math.gcd(48, 32)
    out = port(to_torch(x, tdt))
    assert out.dtype == tdt
    check(out, want, dt)


RES_CASES = [  # (dims, in_ch, out_ch, scale_shift, up, down)
    (3, 8, 8, False, False, False),
    (3, 8, 16, False, False, False),  # skip projection
    (2, 8, 8, True, False, False),  # FiLM scale-shift
    (2, 8, 16, False, True, False),  # up + skip
    (3, 16, 16, True, False, True),  # down + scale-shift
]


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", RES_CASES, ids=lambda c: "d{}_{}to{}_ss{}_up{}_down{}".format(*c))
def test_resblock(case, dt):
    dims, cin, cout, ss, up, down = case
    jdt, tdt = DTYPES[dt]
    rs = np.random.RandomState(1)
    x = rs.randn(2, *(8,) * dims, cin).astype(np.float32)
    emb = rs.randn(2, 32).astype(np.float32)
    m = jb.ResBlock(out_channels=cout, dims=dims, use_scale_shift_norm=ss, up=up, down=down)
    p = init_flax(m, jnp.asarray(x), jnp.asarray(emb))
    want = jax_apply(m, p, jnp.asarray(x, jdt), jnp.asarray(emb, jdt))
    port = load_port(tb.ResBlock(cin, cout, 32, dims, use_scale_shift_norm=ss, up=up, down=down), p)
    with torch.no_grad():
        out = port(to_torch(x, tdt), to_torch(emb, tdt))
    assert out.dtype == tdt
    check(out, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("spatial,heads_ch", [((4, 4, 4), 4), ((32, 32), 8)], ids=["3d_T64", "2d_T1024"])
def test_attention_block(spatial, heads_ch, dt):
    """T=64 takes the plain path, T=1024 the flash dispatch (plain version on
    the CPU); the JAX side takes its XLA attention for both."""
    jdt, tdt = DTYPES[dt]
    x = np.random.RandomState(2).randn(1, *spatial, 16).astype(np.float32)
    m = jb.AttentionBlock(num_heads=16 // heads_ch, num_head_channels=heads_ch)
    p = init_flax(m, jnp.asarray(x))
    want = jax_apply(m, p, jnp.asarray(x, jdt))
    port = load_port(tb.AttentionBlock(16, num_head_channels=heads_ch), p)
    with torch.no_grad():
        out = port(to_torch(x, tdt))
    check(out, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("dims", [2, 3])
def test_up_and_downsample(dims, dt):
    jdt, tdt = DTYPES[dt]
    x = np.random.RandomState(3).randn(1, *(6,) * dims, 8).astype(np.float32)
    for jm, tm in ((jb.Upsample(dims), tb.Upsample(8, dims)), (jb.Downsample(dims), tb.Downsample(8, dims))):
        p = init_flax(jm, jnp.asarray(x))
        want = jax_apply(jm, p, jnp.asarray(x, jdt))
        with torch.no_grad():
            out = load_port(tm, p)(to_torch(x, tdt))
        check(out, want, dt)
