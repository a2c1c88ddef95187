"""PyTorch port: the SAME 3x3x3 conv kernel's module (`ops/conv3d.py`), held
against the JAX package's Pallas `conv3d_3x3` and `conv3d_3x3_v2`.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_conv3d_kernel.py does; the port's wrappers take their plain
version on CPU tensors.  Tolerances (fp32): rtol 1e-4, atol 1e-5, those of
tests/test_conv3d_kernel.py (one fp32 accumulator each, summed in another
order); gradients the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.ops import conv3d as tconv
from jointimagegeneration_tpu.ops.pallas import conv3d as jconv

from test_torch_weights import to_numpy, to_torch

FNS = {"conv3d_3x3": (jconv.conv3d_3x3, tconv.conv3d_3x3),
       "conv3d_3x3_v2": (jconv.conv3d_3x3_v2, tconv.conv3d_3x3_v2)}


def _inputs(seed, shape, cin, cout):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    k = (rs.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
    return x, k


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("shape,cin,cout,th", [
    ((1, 4, 16, 16, 8), 8, 8, 8),
    ((1, 3, 8, 8, 4), 4, 12, 4),
    ((2, 2, 8, 8, 4), 4, 4, 8),  # batch 2: vmapped there, one grid here
])
def test_conv3d_matches_jax_pallas(fn, shape, cin, cout, th):
    jfn, tfn = FNS[fn]
    x, k = _inputs(0, shape, cin, cout)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k), th, False))
    got = to_numpy(tfn(to_torch(x), to_torch(k), tile_h=th))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fn", sorted(FNS))
def test_conv3d_silu_epilogue_matches_jax_pallas(fn):
    jfn, tfn = FNS[fn]
    x, k = _inputs(1, (1, 2, 8, 8, 4), 4, 4)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k), 8, True))
    got = to_numpy(tfn(to_torch(x), to_torch(k), 8, True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fn", sorted(FNS))
def test_conv3d_rejects_ragged_h(fn):
    jfn, tfn = FNS[fn]
    with pytest.raises(AssertionError):
        jfn(jnp.zeros((1, 2, 10, 8, 4)), jnp.zeros((3, 3, 3, 4, 4)), 8)
    with pytest.raises(ValueError, match="tile_h"):
        tfn(torch.zeros(1, 2, 10, 8, 4), torch.zeros(3, 3, 3, 4, 4), 8)


@pytest.mark.parametrize("activate", [False, True])
def test_conv3d_gradients_match_jax_grad(activate):
    x, k = _inputs(2, (1, 2, 8, 8, 4), 4, 4)
    w = np.random.RandomState(3).randn(1, 2, 8, 8, 4).astype(np.float32)  # a non-uniform cotangent
    gj = jax.grad(lambda x, k: jnp.sum(jconv.conv3d_3x3_v2(x, k, 8, activate) * w),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt, kt = to_torch(x).requires_grad_(), to_torch(k).requires_grad_()
    (tconv.conv3d_3x3_v2(xt, kt, 8, activate) * to_torch(w)).sum().backward()
    for got, want in ((xt.grad, gj[0]), (kt.grad, gj[1])):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_bf16_accumulates_in_fp32():
    """bf16 operands, one fp32 accumulator: the plain version's stats are the
    float64 conv's to fp32 rounding, and its output that value rounded once
    to bf16, within one bf16 ulp where the fp32 and float64 sums straddle a
    rounding tie."""
    x, k = _inputs(4, (1, 3, 8, 8, 16), 16, 8)
    xb, kb = to_torch(x, torch.bfloat16), to_torch(k, torch.bfloat16)
    bias = to_torch(np.linspace(-1, 1, 8))
    out, stats = tconv.conv3d_plain(xb, kb, bias=bias, want_stats=True)
    ref = torch.nn.functional.conv3d(xb.double().movedim(-1, 1), kb.double().permute(4, 3, 0, 1, 2),
                                     padding=1).movedim(1, -1) + bias.double()
    assert out.dtype == torch.bfloat16 and stats.dtype == torch.float32 and stats.shape == (2, 8)
    once = to_numpy(ref.float().to(torch.bfloat16))
    # equal but where the fp32 sum and the float64 one round to bf16 on either side of a tie
    assert np.mean(to_numpy(out) == once) >= 0.995
    np.testing.assert_allclose(to_numpy(out), once, rtol=2**-7, atol=0)
    flat = ref.reshape(-1, 8)
    np.testing.assert_allclose(stats.double().numpy(), torch.stack([flat.sum(0), (flat ** 2).sum(0)]).numpy(),
                               rtol=1e-5)


def test_wrappers_check_inputs_and_devices():
    x, k = torch.zeros(1, 2, 8, 8, 4), torch.zeros(3, 3, 3, 4, 4)
    with pytest.raises(ValueError):
        tconv.conv3d_igemm(x, k)  # a CPU tensor: no kernel, and no fallback inside the kernel wrapper
    with pytest.raises(ValueError):
        tconv.conv3d_fused(x.to("meta"), k.to("meta"))  # neither CPU nor CUDA
    with pytest.raises(ValueError):
        tconv.conv3d_fused(x, torch.zeros(3, 3, 3, 5, 4))
    with pytest.raises(TypeError):
        tconv.conv3d_fused(x.half(), k.half())
    with pytest.raises(ValueError):
        tconv.conv3d_fused(x, k, bias=torch.zeros(5))
    with pytest.raises(ValueError):
        tconv.conv3d_fused(x, k, scale=torch.ones(4))
    with pytest.raises(ValueError):
        tconv.channel_stats_reduce(torch.zeros(3, 2, 4))
    assert tconv.conv_flops((1, 64, 128, 128, 64), 64) == pytest.approx(2.32e11, rel=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", ["plain", "affine_bias_stats", "bias_residual", "activate"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_on_cuda(flags, dtype):
    """The Hopper kernel against its plain version on the card at a ragged
    shape (W and Cin not tile multiples), with chip_smoke.py's limits: output
    within 2^-7 (bf16) or 1e-4 (fp32) of max |plain|, stats within 1e-4 of
    max |sum|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs the same check on one")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 3, 8, 10, 12, generator=g, device="cuda").to(dtype)
    k = (torch.randn(3, 3, 3, 12, 20, generator=g, device="cuda") * 0.1)
    kw = {}
    if "affine" in flags:
        kw.update(scale=torch.rand(12, generator=g, device="cuda") + 0.5,
                  shift=torch.randn(12, generator=g, device="cuda"))
    if "bias" in flags:
        kw["bias"] = torch.randn(20, generator=g, device="cuda")
    if "residual" in flags:
        kw["residual"] = torch.randn(2, 3, 8, 10, 20, generator=g, device="cuda").to(dtype)
    kw["want_stats"] = "stats" in flags
    kw["activate"] = flags == "activate"
    before = tconv.conv3d_igemm.launches
    got = tconv.conv3d_igemm(x, k, **kw)
    torch.cuda.synchronize()
    assert tconv.conv3d_igemm.launches == before + 1
    want = tconv.conv3d_plain(x, k, **kw)
    got, want = (got, want) if kw["want_stats"] else ((got,), (want,))
    tol = (2**-7 if dtype == torch.bfloat16 else 1e-4) * want[0].float().abs().max().item()
    assert (got[0].float() - want[0].float()).abs().max().item() <= tol
    if kw["want_stats"]:
        assert (got[1] - want[1]).abs().max().item() <= 1e-4 * want[1].abs().max().item()
