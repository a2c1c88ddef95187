"""PyTorch port: the stage-2 conditioners of `nn/text.py` against the JAX
package's (`TransformerTextEncoder`, `ClassEmbedder`, `HybridConditioner`,
`SpatialRescaler`), the flax weights carried over by
`utils.jax_weights.unet_state_dict_from_jax`, on the CPU.

Tolerance: 1e-5 of the output's scale (fp32; the frameworks sum in another
order; flax's LayerNorm takes the one-pass variance, torch two passes).  The
encoder runs at 40 and at 512 tokens (the flash rule's T >= 512 dispatch, its
plain version on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.nn import text as ttext
from jointimagegeneration_torch.utils.jax_weights import unet_state_dict_from_jax
from jointimagegeneration_tpu.nn import text as jtext

from test_torch_weights import init_flax, jax_apply, to_numpy, to_torch


def _close(got, want, frac=1e-5):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


def _load(module, p):
    state = unet_state_dict_from_jax(p)
    assert sorted(state) == sorted(module.state_dict())
    module.load_state_dict(state)
    return module.eval()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("t", [40, 512])
def test_transformer_text_encoder_matches_jax(t):
    kw = dict(vocab_size=100, embed_dim=32, depth=2, n_heads=2, d_head=16, max_len=512)
    tokens = np.random.RandomState(t).randint(0, 100, (2, t)).astype(np.int32)
    jm = jtext.TransformerTextEncoder(**kw)
    p = init_flax(jm, jnp.asarray(tokens))
    want = np.asarray(jax_apply(jm, p, jnp.asarray(tokens)))
    port = _load(ttext.TransformerTextEncoder(device="cpu", **kw), p)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens))
    assert got.shape == (2, t, 32)
    _close(to_numpy(got), want)
    with pytest.raises(ValueError, match="max_len"):
        port(torch.zeros(1, 513, dtype=torch.long))


def test_class_embedder_matches_jax():
    y = np.array([3, 0, 6], np.int32)
    jm = jtext.ClassEmbedder(n_classes=7, embed_dim=16)
    p = init_flax(jm, jnp.asarray(y))
    port = _load(ttext.ClassEmbedder(7, 16, device="cpu"), p)
    got = to_numpy(port(torch.from_numpy(y)))
    assert got.shape == (3, 1, 16)
    np.testing.assert_array_equal(got, np.asarray(jax_apply(jm, p, jnp.asarray(y))))  # a table lookup


@pytest.mark.parametrize("n_stages,multiplier,method,out", [(1, 0.5, "bilinear", None), (2, 0.5, "bilinear", 4),
                                                            (1, 0.75, "bicubic", 3)])
def test_spatial_rescaler_matches_jax(n_stages, multiplier, method, out):
    x = np.random.RandomState(1).rand(2, 24, 20, 2).astype(np.float32)
    jm = jtext.SpatialRescaler(n_stages=n_stages, multiplier=multiplier, method=method, out_channels=out)
    port = ttext.SpatialRescaler(n_stages, multiplier, method, out_channels=out, in_channels=2, device="cpu")
    if out is None:
        want = np.asarray(jax.jit(lambda a: jm.apply({}, a))(jnp.asarray(x)))
        assert not list(port.parameters())
    else:
        p = init_flax(jm, jnp.asarray(x))
        want = np.asarray(jax_apply(jm, p, jnp.asarray(x)))
        _load(port, p)
    with torch.no_grad():
        got = to_numpy(port(to_torch(x)))
    assert got.shape == want.shape
    _close(got, want)


def test_spatial_rescaler_rejects_what_it_cannot_size():
    with pytest.raises(ValueError, match="in_channels"):
        ttext.SpatialRescaler(out_channels=4, device="cpu")
    with pytest.raises(ValueError, match="method"):
        ttext.SpatialRescaler(method="lanczos3", device="cpu")


def test_hybrid_conditioner_matches_jax():
    """A SpatialRescaler as the concat conditioner, a ClassEmbedder as the
    cross-attention one: the {c_concat, c_crossattn} pair."""
    import flax.linen as fnn

    class JHybrid(fnn.Module):
        @fnn.compact
        def __call__(self, a, y):
            return jtext.HybridConditioner(jtext.SpatialRescaler(out_channels=3, name="concat"),
                                           jtext.ClassEmbedder(5, 8, name="crossattn"))(a, y)

    a = np.random.RandomState(2).rand(2, 16, 16, 2).astype(np.float32)
    y = np.array([4, 1], np.int32)
    p = init_flax(JHybrid(), jnp.asarray(a), jnp.asarray(y))
    want = jax.jit(lambda pp, aa, yy: JHybrid().apply({"params": pp}, aa, yy))(p, jnp.asarray(a), jnp.asarray(y))
    port = ttext.HybridConditioner(ttext.SpatialRescaler(out_channels=3, in_channels=2, device="cpu"),
                                   ttext.ClassEmbedder(5, 8, device="cpu"))
    state = unet_state_dict_from_jax(p)
    port.load_state_dict({k.replace("concat.", "concat_conditioner.").replace("crossattn.", "crossattn_conditioner."): v
                          for k, v in state.items()})
    with torch.no_grad():
        got = port(to_torch(a), torch.from_numpy(y))
    assert sorted(got) == ["c_concat", "c_crossattn"]
    _close(to_numpy(got["c_concat"]), want["c_concat"])
    np.testing.assert_array_equal(to_numpy(got["c_crossattn"]), np.asarray(want["c_crossattn"]))


def test_encoders_fresh_init_is_seeded():
    a, b = (ttext.TransformerTextEncoder(100, 16, 1, 2, 8, 64, device="cpu", seed=3) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert 0.015 < float(a.pos_emb.detach().std()) < 0.025  # flax's normal(0.02)
