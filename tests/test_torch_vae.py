"""PyTorch port: the first-stage autoencoders against the JAX package on the CPU.

`Encoder`, `Decoder`, `AutoencoderKL` (the posterior's moments, mode, kl and
nll, and decode) and `VQModel` (`encode_prequant`, `decode_prequant`, the
code indices) at tiny widths, with the JAX weights carried over by
`ae_state_dict_from_jax` (every leaf non-zero, `proj_out` included).  The
attention sites cover a placed 'vanilla' block, a 'linear' one and 'none';
the asymmetric (0, 1) downsample runs at even and odd sizes.  fp32, each
output within 1e-5 of its max |JAX value| (the convs and GroupNorms sum in
another order); indices exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.models.autoencoder import AutoencoderKL as TKL
from jointimagegeneration_torch.models.autoencoder import DiagonalGaussian as TGauss
from jointimagegeneration_torch.models.autoencoder import VQModel as TVQ
from jointimagegeneration_torch.nn import vae as tvae
from jointimagegeneration_torch.nn.blocks import AttentionBlock as TAttn
from jointimagegeneration_torch.utils.jax_weights import ae_state_dict_from_jax, flatten_tree
from jointimagegeneration_tpu.models.autoencoder import AutoencoderKL, DiagonalGaussian, VQModel
from jointimagegeneration_tpu.nn import vae
from jointimagegeneration_tpu.nn.blocks import AttentionBlock

from test_torch_weights import assert_close_scaled, init_flax, jax_apply, to_numpy, to_torch

TOL = 1e-5
STACK = dict(ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(ae_state_dict_from_jax(params))
    return module.eval()


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("attn_type,size", [("vanilla", 16), ("linear", 16), ("none", 16), ("vanilla", 15)])
def test_encoder_matches_jax(attn_type, size):
    """At 16 the attention is placed at level 1 (resolution 8) and in the mid
    block; at 15 the (0, 1) pad makes the stride-2 conv give 7."""
    jm = vae.Encoder(z_channels=3, attn_type=attn_type, **STACK)
    x = _x(0, 2, size, size, 2)
    p = init_flax(jm, jnp.zeros((1, size, size, 2)))
    want = np.asarray(jax_apply(jm, p, jnp.asarray(x)))
    tm = _load(tvae.Encoder(in_channels=2, z_channels=3, attn_type=attn_type, device="cpu", **STACK), p)
    with torch.no_grad():
        got = to_numpy(tm(to_torch(x)))
    out = (size + 1 - 3) // 2 + 1  # (0, 1) pad, then a VALID 3-tap stride-2 conv
    assert got.shape == want.shape == (2, out, out, 6)
    assert_close_scaled(got, want, TOL)
    assert ("down_1_0_attn" in dict(tm.named_children())) == (attn_type != "none")


def test_encoder_downsample_is_asymmetric():
    """The (0, 1) pad: an odd size 15 gives 7 (pad to 16, then VALID), where a
    symmetric pad of 1 would give 8; at even sizes the two differ in the taps
    read, which the values show."""
    jm = vae.Encoder(z_channels=2, double_z=False, **{**STACK, "attn_resolutions": ()})
    for size, out in ((15, 7), (16, 8), (17, 8)):
        x = _x(size, 1, size, size, 1)
        p = init_flax(jm, jnp.zeros((1, size, size, 1)))
        want = np.asarray(jax_apply(jm, p, jnp.asarray(x)))
        tm = _load(tvae.Encoder(in_channels=1, z_channels=2, double_z=False, device="cpu",
                                **{**STACK, "attn_resolutions": ()}), p)
        with torch.no_grad():
            got = to_numpy(tm(to_torch(x)))
        assert got.shape == want.shape == (1, out, out, 2)
        assert_close_scaled(got, want, TOL)


@pytest.mark.parametrize("attn_type", ["vanilla", "linear", "none"])
def test_decoder_matches_jax(attn_type):
    jm = vae.Decoder(out_ch=2, attn_type=attn_type, **STACK)
    z = _x(1, 2, 8, 8, 3)
    p = init_flax(jm, jnp.zeros((1, 8, 8, 3)))
    want = np.asarray(jax_apply(jm, p, jnp.asarray(z)))
    tm = _load(tvae.Decoder(z_channels=3, out_ch=2, attn_type=attn_type, device="cpu", **STACK), p)
    with torch.no_grad():
        got = to_numpy(tm(to_torch(z)))
    assert got.shape == want.shape == (2, 16, 16, 2)
    assert_close_scaled(got, want, TOL)


@pytest.mark.parametrize("heads,dim_head", [(1, None), (2, 3)])
def test_linear_attention_matches_jax(heads, dim_head):
    jm = vae.LinearAttentionBlock(heads=heads, dim_head=dim_head)
    x = _x(2, 2, 6, 5, 8)
    p = init_flax(jm, jnp.zeros((1, 6, 5, 8)))
    want = np.asarray(jax_apply(jm, p, jnp.asarray(x)))
    tm = _load(tvae.LinearAttentionBlock(8, heads=heads, dim_head=dim_head, device="cpu"), p)
    with torch.no_grad():
        got = to_numpy(tm(to_torch(x)))
    assert tm.to_qkv.bias is None
    assert_close_scaled(got, want, TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_attention_block_eps(eps):
    """The VAE sites' GroupNorm eps 1e-6 against the UNet's 1e-5, on an input
    of small variance, where the two differ."""
    jm = AttentionBlock(num_heads=1, eps=eps)
    x = 1e-3 * _x(3, 1, 4, 4, 8)
    p = init_flax(jm, jnp.zeros((1, 4, 4, 8)))
    want = np.asarray(jax_apply(jm, p, jnp.asarray(x)))
    tm = _load(TAttn(8, num_heads=1, eps=eps, device="cpu"), p)
    with torch.no_grad():
        got = to_numpy(tm(to_torch(x)))
    assert_close_scaled(got, want, TOL)
    assert TAttn(8, device="cpu").norm.eps == 1e-5
    assert tvae.make_attn("vanilla", 8, 2, device="cpu").norm.eps == 1e-6
    with pytest.raises(ValueError):
        tvae.make_attn("flash", 8, 2)


KL = dict(embed_dim=3, ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), z_channels=2,
          in_channels=2, out_ch=2, resolution=16)


@pytest.fixture(scope="module")
def kl_pair():
    jm = AutoencoderKL(**KL)
    p = init_flax(jm, jnp.zeros((1, 16, 16, 2)))
    return jm, p, _load(TKL(device="cpu", **KL), p)


def test_autoencoder_kl_matches_jax(kl_pair):
    jm, p, tm = kl_pair
    x = _x(4, 2, 16, 16, 2)
    jpost = jax.jit(lambda pp, xx: jm.apply({"params": pp}, xx, method=jm.encode))(p, jnp.asarray(x))
    with torch.no_grad():
        tpost = tm.encode(to_torch(x))
        assert tpost.mean.shape == (2, 8, 8, 3)
        for got, want in ((tpost.mean, jpost.mean), (tpost.logvar, jpost.logvar), (tpost.mode(), jpost.mode())):
            assert_close_scaled(to_numpy(got), np.asarray(want), TOL)
        np.testing.assert_allclose(to_numpy(tpost.kl()), np.asarray(jpost.kl()), rtol=1e-4)
        s = _x(13, 2, 8, 8, 3)
        np.testing.assert_allclose(to_numpy(tpost.nll(to_torch(s))), np.asarray(jpost.nll(jnp.asarray(s))), rtol=1e-4)
        z = _x(5, 2, 8, 8, 3)
        want = np.asarray(jax.jit(lambda pp, zz: jm.apply({"params": pp}, zz, method=jm.decode))(p, jnp.asarray(z)))
        got = to_numpy(tm.decode(to_torch(z)))
        assert got.shape == (2, 16, 16, 2)
        assert_close_scaled(got, want, TOL)
        # the whole forward from the mode
        rec_j, _ = jax_apply(jm, p, jnp.asarray(x))
        rec_t, _ = tm(to_torch(x))
        assert_close_scaled(to_numpy(rec_t), np.asarray(rec_j), TOL)
    assert tm.downsample_factor == jm.downsample_factor == 2


def test_diagonal_gaussian_matches_jax():
    """from_moments' clip to [-30, 20], kl, nll, and a sample from given noise."""
    m = _x(6, 2, 4, 4, 6) * 20.0  # some logvars beyond the clip
    jg, tg = DiagonalGaussian.from_moments(jnp.asarray(m)), TGauss.from_moments(to_torch(m))
    assert float(tg.logvar.max()) == 20.0 and float(tg.logvar.min()) == -30.0
    np.testing.assert_array_equal(to_numpy(tg.logvar), np.asarray(jg.logvar))
    m = _x(7, 2, 4, 4, 6)
    jg, tg = DiagonalGaussian.from_moments(jnp.asarray(m)), TGauss.from_moments(to_torch(m))
    np.testing.assert_allclose(to_numpy(tg.kl()), np.asarray(jg.kl()), rtol=1e-5)
    s = _x(8, 2, 4, 4, 3)
    np.testing.assert_allclose(to_numpy(tg.nll(to_torch(s))), np.asarray(jg.nll(jnp.asarray(s))), rtol=1e-5)
    key = jax.random.key(9)
    eps = np.asarray(jax.random.normal(key, (2, 4, 4, 3)))

    class Replay:
        def normal(self, shape):
            assert tuple(shape) == eps.shape
            return to_torch(eps)

    np.testing.assert_allclose(to_numpy(tg.sample(Replay())), np.asarray(jg.sample(key)), atol=1e-6)


VQ = dict(embed_dim=3, n_embed=16, ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), z_channels=2,
          in_channels=1, out_ch=1, resolution=16, attn_type="linear")


def test_vq_model_matches_jax():
    jm = VQModel(**VQ)
    p = init_flax(jm, jnp.zeros((1, 16, 16, 1)))
    p["quantize"]["codebook"] = np.random.RandomState(10).randn(16, 3).astype(np.float32)
    tm = _load(TVQ(device="cpu", **VQ), p)
    x = _x(11, 2, 16, 16, 1)
    run = lambda method, a: jax.jit(lambda pp, aa: jm.apply({"params": pp}, aa, method=method))(p, jnp.asarray(a))  # noqa: E731
    with torch.no_grad():
        h = tm.encode_prequant(to_torch(x))
        assert_close_scaled(to_numpy(h), np.asarray(run(jm.encode_prequant, x)), TOL)
        zq_j, loss_j, idx_j = run(jm.encode, x)
        zq_t, loss_t, idx_t = tm.encode(to_torch(x))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        assert len(np.unique(idx_t.numpy())) > 1
        assert_close_scaled(to_numpy(zq_t), np.asarray(zq_j), TOL)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
        hq = _x(12, 2, 8, 8, 3)
        for force in (False, True):
            want = np.asarray(jax.jit(lambda pp, a: jm.apply({"params": pp}, a, force,
                                                             method=jm.decode_prequant))(p, jnp.asarray(hq)))
            got = to_numpy(tm.decode_prequant(to_torch(hq), force_not_quantize=force))
            assert_close_scaled(got, want, TOL)


def test_bridge_keeps_the_codebook_layout():
    """The codebook (n_embed, embed_dim) is 2-D but no Dense kernel: the bridge
    carries it as it is, while a 2-D Dense kernel is transposed."""
    cb = np.arange(12, dtype=np.float32).reshape(4, 3)
    qkv = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd = ae_state_dict_from_jax({"params": {"quantize": {"codebook": cb},
                                            "mid_attn": {"qkv": {"kernel": qkv, "bias": np.zeros(3, np.float32)}}}})
    np.testing.assert_array_equal(sd["quantize.codebook"].numpy(), cb)
    np.testing.assert_array_equal(sd["mid_attn.qkv.weight"].numpy(), qkv.T)
    # and a whole VQ model: every flax leaf lands on one port parameter, strictly
    jm = VQModel(**{**VQ, "n_embed": 5})
    p = init_flax(jm, jnp.zeros((1, 16, 16, 1)))
    tm = _load(TVQ(device="cpu", **{**VQ, "n_embed": 5}), p)
    assert tm.quantize.codebook.shape == (5, 3)
    np.testing.assert_array_equal(tm.quantize.codebook.detach().numpy(), p["quantize"]["codebook"])
    assert sum(v.size for v in flatten_tree(p).values()) == sum(q.numel() for q in tm.parameters())


def test_fresh_init_follows_the_jax_initialisers():
    """Norm scales one, biases zero, proj_out zero, the codebook in [-1/n, 1/n)."""
    tm = TVQ(device="cpu", **VQ)
    named = {k: v.detach() for k, v in tm.named_parameters()}
    assert float(named["encoder.mid_1.norm1.weight"].min()) == 1.0
    assert float(named["encoder.conv_in.bias"].abs().max()) == 0.0
    assert float(named["encoder.conv_in.weight"].abs().max()) > 0.0
    kl = TKL(device="cpu", **KL)
    assert float(kl.encoder.mid_attn.proj_out.weight.detach().abs().max()) == 0.0
    assert float(tm.quantize.codebook.detach().abs().max()) <= 1.0 / 16
