"""PyTorch port: the cross-attention transformer blocks (`nn/transformer.py`)
and the text-guided UNet against the JAX package's, on the CPU.

Weights come from the flax modules' own trees (every leaf non-zero, the
zero-init proj_out too) through the weight bridge.  Tolerances: fp32 within
1e-5 of each output's max |.| (sums in another order; at Tq >= 512 the port's
flash plain version against the JAX CPU path's XLA attention); the whole
UNet as `test_torch_unet.py` holds it (5e-4); bf16 within 3e-2 of the output
scale, the limit the port's other bf16 tests use."""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.nn import transformer as tt
from jointimagegeneration_torch.nn.unet import UNet as TUNet
from jointimagegeneration_torch.ops.attention import FLASH_MIN_SEQ
from jointimagegeneration_tpu.nn import transformer as jt
from jointimagegeneration_tpu.nn.unet import UNet

from test_torch_weights import assert_close_scaled, init_flax, jax_apply, load_port, to_numpy, to_torch

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, dt, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, DTYPES[dt][0]), to_torch(x, DTYPES[dt][1])


def _check(got, want, dt, frac32=1e-5):
    got, want = to_numpy(got), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert_close_scaled(got, want, frac32 if dt == "fp32" else 3e-2)


def _run(jmod, tmod, jargs, targs):
    p = init_flax(jmod, *jargs)
    want = jax_apply(jmod, p, *jargs)
    with torch.no_grad():
        got = load_port(tmod, p)(*targs)
    return got, want


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_geglu_and_feed_forward(dt):
    jx, tx = _inputs((2, 5, 16), dt)
    got, want = _run(jt.GEGLU(24), tt.GEGLU(16, 24, device="cpu"), (jx,), (tx,))
    _check(got, want, dt)
    got, want = _run(jt.FeedForward(), tt.FeedForward(16, device="cpu"), (jx,), (tx,))
    _check(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("tq", [16, FLASH_MIN_SEQ])
@pytest.mark.parametrize("ctx_len", [None, 4, 512])
def test_cross_attention(dt, tq, ctx_len):
    """Self-attention (no context) and cross-attention over 4 and 512 context
    tokens of another width; at tq = 512 the port takes the flash rule."""
    jx, tx = _inputs((2, tq, 16), dt)
    jargs, targs = (jx,), (tx,)
    if ctx_len:
        jc, tc = _inputs((2, ctx_len, 12), dt, seed=1)
        jargs, targs = (jx, jc), (tx, tc)
    got, want = _run(jt.CrossAttention(heads=2, dim_head=8),
                     tt.CrossAttention(16, 2, 8, context_dim=12 if ctx_len else None, device="cpu"), jargs, targs)
    _check(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["self", "context", "disable_self_attn"])
def test_basic_transformer_block(dt, mode):
    jx, tx = _inputs((1, FLASH_MIN_SEQ, 16), dt)
    jc, tc = _inputs((1, 6, 12), dt, seed=1)
    ctx = mode != "self"
    jmod = jt.BasicTransformerBlock(heads=2, dim_head=8, disable_self_attn=mode == "disable_self_attn")
    tmod = tt.BasicTransformerBlock(16, 2, 8, context_dim=12 if ctx else None,
                                    disable_self_attn=mode == "disable_self_attn", device="cpu")
    got, want = _run(jmod, tmod, (jx, jc) if ctx else (jx,), (tx, tc) if ctx else (tx,))
    _check(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("ctx", [False, True])
def test_sequence_transformer_3d(dt, ctx):
    """A (1, 8, 8, 8, 32) volume: 512 tokens, two blocks, GroupNorm eps 1e-6,
    the zero-init proj_out filled by the test's params."""
    jx, tx = _inputs((1, 8, 8, 8, 32), dt)
    jc, tc = _inputs((1, 4, 12), dt, seed=1)
    jmod = jt.SequenceTransformer(heads=4, dim_head=8, depth=2)
    tmod = tt.SequenceTransformer(32, 4, 8, depth=2, context_dim=12 if ctx else None, device="cpu")
    got, want = _run(jmod, tmod, (jx, jc) if ctx else (jx,), (tx, tc) if ctx else (tx,))
    _check(got, want, dt)


def test_layer_norm_and_gelu_follow_flax():
    """flax's LayerNorm takes epsilon 1e-6 (torch's default is 1e-5) and
    nn.gelu the tanh approximation: on small-variance rows the eps shows."""
    x = (np.random.RandomState(3).randn(4, 7, 24) * 1e-3).astype(np.float32)
    ln = fnn.LayerNorm()
    p = init_flax(ln, jnp.asarray(x))
    want = jax_apply(ln, p, jnp.asarray(x))
    with torch.no_grad():
        got = load_port(tt.LayerNorm(24, device="cpu"), p)(to_torch(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.abs(to_numpy(torch.nn.functional.layer_norm(to_torch(x), (24,))) - np.asarray(want)).max() > 1e-2
    g = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(to_numpy(torch.nn.functional.gelu(to_torch(g), approximate="tanh")),
                               np.asarray(fnn.gelu(jnp.asarray(g))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_text_guided_unet_matches_jax(dt):
    """The stage-1 UNet with context_dim: every attention site (ds 1, 8x8x8 =
    512 tokens, and the mid block) a SequenceTransformer cross-attending over
    a 4-token context."""
    jdt, tdt = DTYPES[dt]
    kw = dict(model_channels=8, out_channels=4, num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1, 2),
              dims=3, num_head_channels=4, softmax_output=True, context_dim=12)
    rs = np.random.RandomState(0)
    x, cond = rs.randn(1, 8, 8, 8, 4).astype(np.float32), rs.rand(1, 8, 8, 8, 1).astype(np.float32)
    ctx, t = rs.randn(1, 4, 12).astype(np.float32), np.array([7.0], np.float32)
    net = UNet(dtype=jdt, **kw)
    p = init_flax(net, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond), context=jnp.asarray(ctx))
    want = np.asarray(jax_apply(net, p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), jnp.asarray(ctx)))
    port = load_port(TUNet(in_channels=5, dtype=tdt, device="cpu", **kw), p)
    assert isinstance(port.down_0_0_attn, tt.SequenceTransformer) and port.mid_attn.block_0.attn2.to_k.in_features == 12
    with torch.no_grad():
        got = to_numpy(port(to_torch(x), to_torch(t), cond=to_torch(cond), context=to_torch(ctx)))
        other = to_numpy(port(to_torch(x), to_torch(t), cond=to_torch(cond), context=to_torch(-ctx)))
    assert np.abs(other - got).max() > 1e-4  # the output reads the context
    if dt == "fp32":
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * np.abs(want).max())
    else:
        assert_close_scaled(got, want, 3e-2)
