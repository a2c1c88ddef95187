"""PyTorch port: the fused stage-1 ResBlock path (`ops/fused_resblock.py`,
`ResBlock(fused=..., pallas_conv=...)`, `UNet(use_fused_resblock=...)`,
`MaskSampler.create(use_fused_resblock=...)`), held against the JAX package.

The kernel functions are held against the JAX Pallas kernel in interpret mode
(`_FORCE_PALLAS`, set and restored as tests/test_fused_resblock.py does); the
blocks and the UNet against the JAX modules, whose fused path takes the
kernel's XLA reference on the CPU.  Weights come from `init_flax` (every
kernel non-zero, conv2 included) through the weight bridge.  Tolerances:
kernel outputs 2e-5 and stats atol 1e-2 / rtol 1e-4 (tests/test_fused_resblock.py's,
fp32 sums of 256 voxels in another order); blocks in fp32 within 2e-4
(relative, and of the output scale), in bf16 within 3e-2 of the output scale
(bf16 rounds at other places in the two frameworks); gradients within 1e-4 of
the largest gradient; the UNet in fp32 within 5e-4 as tests/test_torch_unet.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.nn import blocks as tb
from jointimagegeneration_torch.ops import fused_resblock as tfr
from jointimagegeneration_torch.utils.jax_weights import unet_state_dict_from_jax
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler
from jointimagegeneration_tpu.nn import blocks as jb
from jointimagegeneration_tpu.ops.pallas import fused_resblock as jfr

from test_torch_weights import (ReplayNoise, assert_close_scaled, init_flax, jax_apply, load_port, to_numpy,
                                to_torch)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _kernel_inputs(bias, residual, d=4, h=8, w=8, cin=8, cout=8):
    rs = np.random.RandomState(0)
    x = rs.randn(1, d, h, w, cin).astype(np.float32)
    k = (rs.randn(3, 3, 3, cin, cout) * 0.2).astype(np.float32)
    scale = (np.abs(rs.randn(cin)) + 0.5).astype(np.float32)
    shift = (rs.randn(cin) * 0.1).astype(np.float32)
    b = rs.randn(cout).astype(np.float32) if bias else None
    r = rs.randn(1, d, h, w, cout).astype(np.float32) if residual else None
    return x, k, scale, shift, b, r


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else to_torch(a)


@pytest.mark.parametrize("mode", ["affine", "preactivated"])
@pytest.mark.parametrize("bias,residual,want_stats", [(False, False, False), (True, False, True),
                                                      (True, True, False)])
def test_kernel_functions_match_jax_pallas(bias, residual, want_stats, mode):
    x, k, scale, shift, b, r = _kernel_inputs(bias, residual)
    jfr._FORCE_PALLAS[0] = True
    try:
        if mode == "affine":
            want = jfr.fused_affine_silu_conv3d(_j(x), _j(k), _j(scale), _j(shift), _j(b), _j(r), want_stats, 4)
        else:
            want = jfr.fused_conv3d(_j(x), _j(k), _j(b), _j(r), want_stats, 4)
    finally:
        jfr._FORCE_PALLAS[0] = False
    if mode == "affine":
        got = tfr.fused_affine_silu_conv3d(_t(x), _t(k), _t(scale), _t(shift), _t(b), _t(r), want_stats, 4)
    else:
        got = tfr.fused_conv3d(_t(x), _t(k), _t(b), _t(r), want_stats, 4)
    if want_stats:
        np.testing.assert_allclose(to_numpy(got[0]), np.asarray(want[0]), atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(to_numpy(got[1]), np.asarray(want[1]), atol=1e-2, rtol=1e-4)
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_plain_version_matches_jax_reference_in_bf16():
    """bf16: t rounded to bf16 before the product, fp32 accumulator, one cast."""
    x, k, scale, shift, b, r = _kernel_inputs(True, True)
    want = jfr._xla_reference(jnp.asarray(x, jnp.bfloat16), _j(k), _j(scale), _j(shift), _j(b),
                              jnp.asarray(r, jnp.bfloat16), True)
    got = tfr.fused_conv3d_plain(to_torch(x, torch.bfloat16), _t(k), _t(scale), _t(shift), _t(b),
                                 to_torch(r, torch.bfloat16), True)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert_close_scaled(to_numpy(got[0]), np.asarray(want[0].astype(jnp.float32)), 2**-7)
    np.testing.assert_allclose(to_numpy(got[1]), np.asarray(want[1]), rtol=1e-4, atol=1e-2)


def test_fused_functions_check_batch_and_h():
    x, k = torch.zeros(2, 2, 8, 8, 4), torch.zeros(3, 3, 3, 4, 4)
    with pytest.raises(ValueError, match="one"):
        tfr.fused_conv3d(x, k, None, None)
    with pytest.raises(ValueError, match="tile_h"):
        tfr.fused_affine_silu_conv3d(x[:1, :, :6], k, torch.ones(4), torch.zeros(4), None, None)


def test_gn_helpers_match_jax():
    rs = np.random.RandomState(1)
    c, groups = 16, 4
    x = (rs.randn(1, 4, 6, 6, c) * 2 + 3).astype(np.float32)  # a mean, so the one-pass var cancels some
    gamma = (np.abs(rs.randn(c)) + 0.5).astype(np.float32)
    beta = rs.randn(c).astype(np.float32)
    jm, jv = jfr.group_moments(jnp.asarray(x), groups)
    tm, tv = tfr.group_moments(to_torch(x), groups)
    np.testing.assert_allclose(to_numpy(tm), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_numpy(tv), np.asarray(jv), rtol=1e-5, atol=1e-5)
    js = jfr.gn_affine_from_moments(jm, jv, jnp.asarray(gamma), jnp.asarray(beta), groups)
    ts = tfr.gn_affine_from_moments(tm, tv, to_torch(gamma), to_torch(beta), groups)
    for got, want in zip(ts, js):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    flat = x.reshape(-1, c).astype(np.float64)
    stats = np.stack([flat.sum(0), (flat ** 2).sum(0)]).astype(np.float32)
    jm2, jv2 = jfr.moments_from_channel_sums(jnp.asarray(stats), flat.shape[0], groups)
    tm2, tv2 = tfr.moments_from_channel_sums(to_torch(stats), flat.shape[0], groups)
    np.testing.assert_allclose(to_numpy(tm2), np.asarray(jm2), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_numpy(tv2), np.asarray(jv2), rtol=1e-5, atol=1e-5)
    # the clamp: moments whose E[x^2] - mean^2 cancels below zero give var 0, not a NaN later
    neg = to_torch(np.array([[4.0, 4.0], [15.9, 16.0]], np.float32))
    assert float(tfr.moments_from_channel_sums(neg, 1, 2)[1].min()) == 0.0


def test_kernel_function_grads_match_jax_grad():
    x, k, scale, shift, b, _ = _kernel_inputs(True, False)

    def loss_j(x, k, scale, shift, b):
        y, st = jfr.fused_affine_silu_conv3d(x, k, scale, shift, b, None, True, 4)
        return jnp.sum(y ** 2) + 1e-3 * jnp.sum(st)

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, k, scale, shift, b)))
    ts = [to_torch(a).requires_grad_() for a in (x, k, scale, shift, b)]
    y, st = tfr.fused_affine_silu_conv3d(*ts, None, True, 4)
    ((y ** 2).sum() + 1e-3 * st.sum()).backward()
    for t, w in zip(ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(to_numpy(t.grad), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def _block_pair(in_ch, out_ch, ssn, mode, spatial=(4, 8, 8), batch=1, down=False, pallas=False, seed=0):
    rs = np.random.RandomState(seed + 10)
    x = rs.randn(batch, *spatial, in_ch).astype(np.float32)
    emb = rs.randn(batch, 12).astype(np.float32)
    jm = jb.ResBlock(out_ch, dims=3, use_scale_shift_norm=ssn, down=down, fused=mode, pallas_conv=pallas)
    p = init_flax(jm, jnp.asarray(x), jnp.asarray(emb), seed=seed)
    tm = load_port(tb.ResBlock(in_ch, out_ch, 12, 3, use_scale_shift_norm=ssn, down=down, fused=mode,
                               pallas_conv=pallas, device="cpu"), p)
    return jm, p, tm, x, emb


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["kernel", "xla", True])
@pytest.mark.parametrize("in_ch,out_ch,ssn", [(8, 8, False), (8, 16, False), (8, 8, True)])
def test_resblock_fused_matches_jax(in_ch, out_ch, ssn, mode, dt):
    jdt, tdt = DTYPES[dt]
    jm, p, tm, x, emb = _block_pair(in_ch, out_ch, ssn, mode)
    assert tm.can_fuse(to_torch(x))
    want = np.asarray(jax_apply(jm, p, jnp.asarray(x, jdt), jnp.asarray(emb, jdt)).astype(jnp.float32))
    with torch.no_grad():
        got = tm(to_torch(x, tdt), to_torch(emb, tdt))
    assert got.dtype == tdt
    if dt == "fp32":
        np.testing.assert_allclose(to_numpy(got), want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    else:
        assert_close_scaled(to_numpy(got), want, 3e-2)


@pytest.mark.parametrize("mode", ["kernel", "xla"])
def test_resblock_fused_grads_match_jax_grad(mode):
    """d(sum(out * w)) by the params and x; 64 channels, so each GroupNorm
    group holds two and no bias gradient is exactly zero."""
    jm, p, tm, x, emb = _block_pair(64, 64, False, mode)
    w = np.random.RandomState(5).randn(1, 4, 8, 8, 64).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x, jnp.asarray(emb)) * w)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = to_torch(x).requires_grad_()
    (tm(xt, to_torch(emb)) * to_torch(w)).sum().backward()
    want = unet_state_dict_from_jax(jax.tree.map(np.asarray, gp))
    want["x"] = torch.tensor(np.asarray(gx))
    got = {n: q.grad for n, q in tm.named_parameters()}
    got["x"] = xt.grad
    assert sorted(got) == sorted(want)
    top = max(v.abs().max().item() for v in want.values())
    for n in want:
        np.testing.assert_allclose(to_numpy(got[n]), want[n].numpy(), rtol=1e-4, atol=1e-4 * top, err_msg=n)


@pytest.mark.parametrize("case", ["h_not_multiple_of_8", "down", "batch_2"])
def test_ineligible_blocks_take_the_unfused_path_in_both(case, monkeypatch):
    kw = {"h_not_multiple_of_8": dict(spatial=(4, 6, 6)), "down": dict(down=True),
          "batch_2": dict(batch=2)}[case]
    jm, p, tm, x, emb = _block_pair(8, 8, False, "kernel", **kw)
    assert not tm.can_fuse(to_torch(x))
    ju = jb.ResBlock(8, dims=3, down=kw.get("down", False), fused=False)
    want_fused_mode = np.asarray(jax_apply(jm, p, jnp.asarray(x), jnp.asarray(emb)))
    want_unfused = np.asarray(jax_apply(ju, p, jnp.asarray(x), jnp.asarray(emb)))
    np.testing.assert_array_equal(want_fused_mode, want_unfused)  # the JAX block fell back too
    monkeypatch.setattr(tb, "fused_affine_silu_conv3d", None)  # a fused call would fail here
    with torch.no_grad():
        got = tm(to_torch(x), to_torch(emb))
    np.testing.assert_allclose(to_numpy(got), want_unfused, rtol=1e-5, atol=1e-5 * np.abs(want_unfused).max())


def test_resblock_pallas_conv_routes_at_cin_128(monkeypatch):
    """(1, 1, 64, 64, 128) -> 128: both convs fit the routing rule (Cin 128,
    H 64); the JAX block runs conv3d_3x3_v2 in interpret mode."""
    jm, p, tm, x, emb = _block_pair(128, 128, False, False, spatial=(1, 64, 64), pallas=True)
    want = np.asarray(jax_apply(jm, p, jnp.asarray(x), jnp.asarray(emb)))
    calls = []
    real = tb.conv3d_3x3_v2
    monkeypatch.setattr(tb, "conv3d_3x3_v2", lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        got = tm(to_torch(x), to_torch(emb))
    assert calls == [(1, 1, 64, 64, 128)] * 2
    np.testing.assert_allclose(to_numpy(got), want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    calls.clear()
    with torch.no_grad():  # H 32 < 64: not routed
        tm(to_torch(x[:, :, :32, :32]), to_torch(emb))
    assert calls == []


_TINY = dict(num_classes=4, time_steps=20, model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,),
             num_res_blocks=1, num_head_channels=4)
_SHAPE = (1, 4, 16, 16)  # H 16 at level 0 and 8 at level 1: every ResBlock fuses


@pytest.fixture(scope="module")
def tiny_params():
    """The parameter tree of a JAX UNet(use_fused_resblock=True): the same
    names and shapes as the unfused tree's."""
    args = (jnp.zeros((*_SHAPE, 4)), jnp.zeros((1,)))
    fused = init_flax(MaskSampler.create(use_fused_resblock=True, **_TINY).unet, *args,
                      cond=jnp.zeros((*_SHAPE, 1)))
    plain = jax.eval_shape(MaskSampler.create(**_TINY).unet.init, jax.random.key(0), *args,
                           cond=jnp.zeros((*_SHAPE, 1)))["params"]
    assert jax.tree.map(np.shape, fused) == jax.tree.map(lambda s: s.shape, plain)
    return fused


@pytest.mark.parametrize("mode", ["kernel", "xla"])
def test_fused_mask_sampler_matches_jax(mode, tiny_params):
    """The slice: weights from the JAX tree through `unet_state_dict_from_jax`
    (strict load, unchanged names), the UNet's probabilities, then one
    denoise step with the JAX draw replayed."""
    jm = MaskSampler.create(use_fused_resblock=mode, **_TINY)
    tm = TMask.create(cond_channels=1, use_fused_resblock=mode, device="cpu", **_TINY)
    load_port(tm.unet, tiny_params)
    blocks = [m for m in tm.unet.modules() if isinstance(m, tb.ResBlock)]
    assert len(blocks) == 8 and all(b.fused == mode for b in blocks)
    rs = np.random.RandomState(3)
    xt = np.eye(4, dtype=np.float32)[rs.randint(0, 4, _SHAPE)]
    cond = rs.rand(*_SHAPE, 1).astype(np.float32)
    t = np.array([13], np.int32)
    want = np.asarray(jax_apply(jm.unet, tiny_params, jnp.asarray(xt), jnp.asarray(t, jnp.float32),
                                jnp.asarray(cond)))
    with torch.no_grad():
        got = to_numpy(tm.unet(to_torch(xt), to_torch(t), cond=to_torch(cond)))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * np.abs(want).max())

    key = jax.random.key(4)
    want_step = np.asarray(jm.denoise_step({"params": tiny_params}, key, jnp.asarray(xt), jnp.asarray(t),
                                           cond=jnp.asarray(cond)))
    draw = np.asarray(jax.random.gumbel(key, (*_SHAPE, 4), jnp.float32))
    noise = ReplayNoise([("gumbel", draw)])
    got_step = tm.denoise_step(noise, to_torch(xt), torch.tensor(t), cond=to_torch(cond)).numpy()
    assert not noise.draws
    np.testing.assert_array_equal(got_step, want_step)
