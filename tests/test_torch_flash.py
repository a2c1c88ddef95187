"""PyTorch port: the flash-attention module and the attention dispatch, held
against the JAX package.

The JAX side runs `_flash_forward` in Pallas interpret mode on the CPU, as
tests/test_flash_attention.py does.  Tolerances (fp32): the plain version and
the blockwise kernel differ only in summation order, so O and LSE agree to
2e-5 absolute on unit-variance inputs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.ops import attention as tattn
from jointimagegeneration_torch.ops import flash_attention as tflash
from jointimagegeneration_tpu.ops.attention import _xla_attention, multi_head_self_attention
from jointimagegeneration_tpu.ops.pallas.flash_attention import _flash_forward, flash_attention

from test_torch_weights import assert_close_scaled, to_numpy, to_torch

ATOL = 2e-5


def _qkv(seed, bh, tq, tk, d):
    rs = np.random.RandomState(seed)
    q = (rs.randn(bh, tq, d) / math.sqrt(d)).astype(np.float32)
    return q, rs.randn(bh, tk, d).astype(np.float32), rs.randn(bh, tk, d).astype(np.float32)


@pytest.mark.parametrize("bh,t,d", [(2, 256, 32), (2, 128, 16)])
def test_plain_matches_jax_flash_forward(bh, t, d):
    q, k, v = _qkv(0, bh, t, t, d)
    o_j, lse_j = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128, 128)
    o_t, lse_t = tflash.flash_forward(to_torch(q), to_torch(k), to_torch(v))  # CPU: plain version
    assert lse_t.shape == lse_j.shape == (bh, t, 1) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(o_t), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(to_numpy(lse_t), np.asarray(lse_j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [128, 384, 512, 1536, 100, 1100, 1088])
def test_eligibility_agrees_with_jax(t):
    """flash_eligible says yes exactly where the JAX flash_attention accepts
    the shape (flash_attention.py:406-413)."""
    x = jnp.zeros((1, 1, t, 16))
    try:
        flash_attention(x, x, x)
        jax_ok = True
    except ValueError:
        jax_ok = False
    assert tflash.flash_eligible(t, t, 16) == jax_ok
    assert not tflash.flash_eligible(t, t, 512)


def test_flash_attention_scales_q_by_inv_sqrt_d():
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(1, 2, 128, 16).astype(np.float32) for _ in range(3))
    out_j = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128)
    out_t = tflash.flash_attention(to_torch(q), to_torch(k), to_torch(v))
    np.testing.assert_allclose(to_numpy(out_t), np.asarray(out_j), atol=ATOL, rtol=0)


def test_wrapper_checks_inputs():
    q = torch.zeros(1, 64, 16)
    with pytest.raises(ValueError):
        tflash.flash_forward(q, torch.zeros(1, 64, 8), torch.zeros(1, 64, 8))
    with pytest.raises(TypeError):
        tflash.flash_forward(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        tflash.flash_forward(torch.zeros(1, 4, 300), torch.zeros(1, 4, 300), torch.zeros(1, 4, 300))
    with pytest.raises(ValueError):
        tflash.flash_forward(q.to("meta"), q.to("meta"), q.to("meta"))  # no kernel, no plain fallback


@pytest.mark.parametrize("t,dtype", [(256, torch.float32), (1024, torch.float32), (1024, torch.bfloat16)])
def test_self_attention_dispatch_matches_jax(t, dtype):
    """multi_head_self_attention: [q | k | v] contiguous chunks, then heads.
    T=256 takes the plain d^-1/4 path, T=1024 the flash path (its plain
    version here); both match the JAX XLA attention."""
    rs = np.random.RandomState(4)
    qkv = rs.randn(2, t, 3 * 16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(multi_head_self_attention(jnp.asarray(qkv, jdt), 4).astype(jnp.float32))
    before = tflash.flash_forward.launches
    got = to_numpy(tattn.multi_head_self_attention(to_torch(qkv, dtype), 4))
    assert tflash.flash_forward.launches == before  # no kernel launch on the CPU
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        assert_close_scaled(got, want, 3e-2)


def test_plain_attention_matches_jax_xla():
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(2, 3, 64, 8).astype(np.float32) for _ in range(3))
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = to_numpy(tattn.plain_attention(to_torch(q), to_torch(k), to_torch(v)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,dtype", [
    (8, 2048, 2048, 32, torch.bfloat16), (16, 1024, 1024, 32, torch.bfloat16),
    (16, 4096, 4096, 32, torch.bfloat16), (20, 1024, 1024, 32, torch.bfloat16),
    (3, 100, 77, 40, torch.bfloat16), (2, 130, 200, 256, torch.bfloat16), (2, 130, 40, 40, torch.bfloat16),
    (4, 512, 512, 32, torch.float32), (3, 100, 77, 40, torch.float32)])
def test_kernel_matches_plain_on_cuda(bh, tq, tk, d, dtype):
    """The Hopper kernel against its plain version on the card, with
    chip_smoke.py's limits: O within 2^-6 (bf16: four bf16 ulps at the top of
    a binade) or 1e-4 (fp32) of the plain output's max |O|; LSE within 1e-4;
    a second call bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same check on one")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = (torch.randn(bh, tq, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
    k = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype)
    before = tflash.flash_forward.launches
    o, lse = tflash.flash_forward(q, k, v)
    o2, lse2 = tflash.flash_forward(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_forward.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    po, plse = tflash.flash_attention_plain(q, k, v)
    tol_o = (4 * 2**-8 if dtype == torch.bfloat16 else 1e-4) * po.float().abs().max().item()
    assert (o.float() - po.float()).abs().max().item() <= tol_o
    assert (lse - plse).abs().max().item() <= 1e-4
