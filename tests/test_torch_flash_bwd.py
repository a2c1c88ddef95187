"""PyTorch port: the flash-attention backward (plain version, autograd
Function, wrappers) held against the JAX package's custom_vjp.

The JAX side differentiates `flash_attention` with `jax.grad`, which runs the
Pallas backward kernels (`_bwd_dkv_kernel`, `_bwd_dq_kernel`) in interpret
mode on the CPU, as tests/test_flash_attention.py does; the port runs its
plain versions on CPU tensors.  Tolerances, each against the gradient's own
max |g|: fp32 1e-5 (the two sum the same products in another order); bf16
2^-6 (both round P and dS to bf16 before the products, but a product that
lands near a rounding boundary can round one bf16 ulp, 2^-8 to 2^-7 of a
value, the other way, and the error carries through one more product)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.ops import attention as tattn
from jointimagegeneration_torch.ops import flash_attention as tflash
from jointimagegeneration_tpu.ops.attention import multi_head_self_attention
from jointimagegeneration_tpu.ops.pallas.flash_attention import _flash_backward, _flash_forward, flash_attention

from test_torch_weights import to_numpy, to_torch

TOL = {torch.float32: 1e-5, torch.bfloat16: 2**-6}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed, b, h, tq, tk, d):
    rs = np.random.RandomState(seed)
    q, do = (rs.randn(b, h, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _assert_scaled(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * scale, f"{what}: max abs err {err} > {frac} x max|g| {scale}"


@pytest.mark.parametrize("b,h,tq,tk,d,dtype", [
    (1, 2, 256, 256, 32, torch.float32),
    (1, 2, 512, 512, 64, torch.float32),
    (1, 2, 256, 128, 32, torch.float32),
    (1, 2, 256, 256, 32, torch.bfloat16),
    (2, 1, 512, 256, 64, torch.bfloat16),
])
def test_backward_matches_jax_grad(b, h, tq, tk, d, dtype):
    """Autograd through the port's `flash_attention` (the Function, its
    backward on the CPU) against jax.grad through the custom_vjp, 128-blocks
    so the Pallas kernels loop over several q and k blocks."""
    q, k, v, do = _inputs(0, b, h, tq, tk, d)
    jq, jk, jv, jdo = (jnp.asarray(x, JDT[dtype]) for x in (q, k, v, do))
    f = lambda q, k, v: jnp.vdot(flash_attention(q, k, v, block_q=128, block_k=128).astype(jnp.float32),
                                 jdo.astype(jnp.float32))
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tq_, tk_, tv_ = (to_torch(x, dtype).requires_grad_() for x in (q, k, v))
    out = tflash.flash_attention(tq_, tk_, tv_)
    got = torch.autograd.grad(out, (tq_, tk_, tv_), to_torch(do, dtype))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == tuple(w.shape)
        _assert_scaled(to_numpy(g), np.asarray(w.astype(jnp.float32)), TOL[dtype], name)


@pytest.mark.parametrize("tq,tk,d,dtype", [(256, 256, 32, torch.float32), (256, 128, 16, torch.bfloat16)])
def test_plain_backward_matches_jax_flash_backward(tq, tk, d, dtype):
    """`flash_backward_plain` step for step against `_flash_backward` on the
    same (q pre-scaled, k, v, O, LSE, dO), O and LSE from the JAX forward."""
    q, k, v, do = (x[0] for x in _inputs(1, 1, 2, tq, tk, d))
    q = q / math.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(x, JDT[dtype]) for x in (q, k, v, do))
    o, lse = _flash_forward(jq, jk, jv, 128, 128)
    want = _flash_backward(jq, jk, jv, o, lse, jdo, 128, 128)
    t = lambda x: torch.tensor(np.asarray(jnp.asarray(x, jnp.float32))).to(dtype)
    got = tflash.flash_backward(t(jq), t(jk), t(jv), t(o), torch.tensor(np.asarray(lse)), t(jdo))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_scaled(to_numpy(g), np.asarray(w.astype(jnp.float32)), TOL[dtype], name)


def test_function_gradcheck_float64():
    """The Function's gradient (its plain path) against finite differences."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, n, 6, generator=g, dtype=torch.float64, requires_grad=True)
               for n in (5, 7, 7))
    assert torch.autograd.gradcheck(tflash.FlashAttention.apply, (q, k, v))


def test_self_attention_flash_site_differentiates_on_cpu():
    """A T = 512 site takes the flash branch (its plain versions here, no
    launch) and its input gradient matches jax.grad of the JAX dispatch (XLA
    attention on the CPU)."""
    rs = np.random.RandomState(2)
    qkv, dout = rs.randn(1, 512, 3 * 16).astype(np.float32), rs.randn(1, 512, 16).astype(np.float32)
    want = jax.grad(lambda x: jnp.vdot(multi_head_self_attention(x, 4), jnp.asarray(dout)))(jnp.asarray(qkv))
    launches = (tflash.flash_forward.launches, tflash.flash_bwd_dkv.launches, tflash.flash_bwd_dq.launches)
    x = to_torch(qkv).requires_grad_()
    (got,) = torch.autograd.grad(tattn.multi_head_self_attention(x, 4), x, to_torch(dout))
    assert launches == (tflash.flash_forward.launches, tflash.flash_bwd_dkv.launches, tflash.flash_bwd_dq.launches)
    _assert_scaled(to_numpy(got), np.asarray(want), 1e-5, "d qkv")


def test_backward_wrappers_check_inputs():
    q = torch.zeros(1, 64, 16)
    lse = torch.zeros(1, 64, 1)
    with pytest.raises(ValueError):  # LSE of the wrong shape
        tflash.flash_backward(q, q, q, q, torch.zeros(1, 64), q)
    with pytest.raises(ValueError):  # dO of another dtype than q
        tflash.flash_backward(q, q, q, q, lse, q.double())
    with pytest.raises(TypeError):
        tflash.flash_backward(q.half(), q.half(), q.half(), q.half(), lse, q.half())
    for fn in (tflash.flash_bwd_dkv, tflash.flash_bwd_dq):  # kernel launchers: CUDA tensors only
        with pytest.raises(ValueError):
            fn(q, q, q, q, lse, lse)
    for ws, out in ((torch.zeros(2, 64), torch.zeros(65)), (torch.zeros(1, 64), torch.zeros(64)),
                    (torch.zeros(2, 64).double(), torch.zeros(64).double())):
        with pytest.raises(ValueError):  # the split reduce: (splits >= 2, *out.shape) fp32
            tflash.flash_bwd_reduce(ws, out)
    m = q.to("meta")
    with pytest.raises(ValueError):  # no kernel for the device, and no plain fallback
        tflash.flash_backward(m, m, m, m, lse.to("meta"), m)


def test_split_reduce_plain_sums_in_split_order():
    """On CPU tensors the reduce computes its plain version: the partials
    summed in split order, as the kernel sums, bit for bit; no launch."""
    ws = torch.from_numpy(np.random.RandomState(4).randn(5, 3, 8).astype(np.float32)) * 1e3
    before = tflash.flash_bwd_reduce.launches
    out = tflash.flash_bwd_reduce(ws, torch.empty(3, 8))
    want = ws[0].clone()
    for s in range(1, 5):
        want = want + ws[s]
    assert torch.equal(out, want) and torch.equal(tflash.flash_bwd_reduce_plain(ws), want)
    assert tflash.flash_bwd_reduce.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bh,tq,tk,d,dtype", [
    (8, 2048, 2048, 32, torch.bfloat16), (16, 1024, 1024, 32, torch.bfloat16), (16, 4096, 4096, 32, torch.bfloat16),
    (3, 100, 77, 40, torch.bfloat16), (2, 130, 200, 256, torch.bfloat16), (2, 300, 200, 64, torch.bfloat16),
    (4, 512, 512, 32, torch.float32), (3, 100, 77, 40, torch.float32), (8, 512, 512, 64, torch.float32),
    (8, 640, 640, 64, torch.float32), (3, 1000, 77, 40, torch.float32)])
def test_backward_kernels_match_plain_on_cuda(bh, tq, tk, d, dtype):
    """The two Hopper kernels against the plain version on the card, with
    chip_smoke.py's limits: each of dQ, dK, dV within 2^-6 (bf16) or 1e-4
    (fp32) of its max |plain|; one launch of each kernel, and of the split
    reduce for each kernel whose fp32 loop the plan splits; a second call
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same check on one")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = (torch.randn(bh, tq, d, generator=g, device="cuda") / math.sqrt(d)).to(dtype)
    k, v = (torch.randn(bh, tk, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    do = torch.randn(bh, tq, d, generator=g, device="cuda").to(dtype)
    o, lse = tflash.flash_forward(q, k, v)
    before = (tflash.flash_bwd_dkv.launches, tflash.flash_bwd_dq.launches, tflash.flash_bwd_reduce.launches)
    got = tflash.flash_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    plan = tflash.plan_flash_bwd(bh, tq, tk, d, dtype)
    reduces = plan.dkv.reduce_launches + plan.dq.reduce_launches
    assert (tflash.flash_bwd_dkv.launches, tflash.flash_bwd_dq.launches, tflash.flash_bwd_reduce.launches) == (
        before[0] + 1, before[1] + 1, before[2] + reduces)
    want = tflash.flash_backward_plain(q, k, v, o, lse, do)
    again = tflash.flash_backward(q, k, v, o, lse, do)
    rel = 2**-6 if dtype == torch.bfloat16 else 1e-4
    for a, a2, b in zip(got, again, want):
        assert (a.float() - b.float()).abs().max().item() <= rel * b.float().abs().max().item()
        assert torch.equal(a, a2)
