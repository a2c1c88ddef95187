"""PyTorch port: the DINO ViT extractor against the JAX package on the CPU.

A tiny ViT (dim 32, depth 2, 2 heads, patch 8, `pos_grid` 4) at 24x24 (the
pos-embed's 4x4 grid shrunk to 3x3: the antialiased bicubic), 32x32 (kept)
and 48x48 and at stride 4 (grown), every facet; `extract_descriptors` with
`log_bin`; `extract_saliency_maps`; the DINO-named torch loader on a seeded
state dict in both packages; its ValueError on a shape the JAX loader would
skip; `make_dense_feature_fn` on 1-, 2- and 3-channel images (the bilinear
resize to the site grid); `jax_image_resize` against `jax.image.resize`.
The JAX weights come over by `vit_state_dict_from_jax`.  fp32, within 1e-5
of each output's max |JAX value|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.models import cond_encoders as tce
from jointimagegeneration_torch.nn import vit as tvit
from jointimagegeneration_torch.utils.jax_weights import vit_state_dict_from_jax
from jointimagegeneration_tpu.models import cond_encoders as jce
from jointimagegeneration_tpu.nn import vit as jvit

from test_torch_weights import assert_close_scaled, init_flax, to_numpy, to_torch

TOL = 1e-5
TINY = dict(dim=32, depth=2, heads=2, patch=8, pos_grid=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(stride=8, seed=0):
    """(JAX extractor with seeded params, port extractor with the same)."""
    jext = jvit.ViTExtractor()
    jext.vit = jvit.ViT(stride=stride, **TINY)
    p = init_flax(jext.vit, jnp.zeros((1, 32, 32, 3)), seed=seed)
    jext.params = {"params": p}
    text = object.__new__(tvit.ViTExtractor)  # the tiny trunk in place of ViT-S, as the JAX test swaps it
    text.vit = tvit.ViT(stride=stride, **TINY).eval().requires_grad_(False)
    text.vit.load_state_dict(vit_state_dict_from_jax(p))
    text.device = torch.device("cpu")
    return jext, text


def _images(seed, size, c=3, b=2):
    return np.random.RandomState(seed).uniform(-1, 1, (b, size, size, c)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("size", [24, 32, 48])
@pytest.mark.parametrize("facet", ["key", "token", "attn"])
def test_extract_matches_jax(pair, size, facet):
    jext, text = pair
    x = _images(size, size)
    want = [np.asarray(a) for a in jax.jit(lambda im: jext.extract(im, layers=(0, 1), facet=facet))(jnp.asarray(x))]
    got = [to_numpy(a) for a in text.extract(to_torch(x), layers=(0, 1), facet=facet)]
    g = size // 8
    shape = (2, 2, g * g + 1, g * g + 1) if facet == "attn" else (2, g, g, 32)
    for a, b in zip(got, want):
        assert a.shape == b.shape == shape
        assert_close_scaled(a, b, TOL)


def test_overlapping_patches_match_jax():
    """Stride 4 under a patch of 8: a 7x7 grid at 32x32, the pos-embed grown."""
    jext, text = _pair(stride=4, seed=3)
    x = _images(7, 32)
    want = np.asarray(jax.jit(lambda im: jext.extract(im, layers=(1,), facet="key")[0])(jnp.asarray(x)))
    got = to_numpy(text.extract(to_torch(x), layers=(1,), facet="key")[0])
    assert got.shape == want.shape == (2, 7, 7, 32)
    assert_close_scaled(got, want, TOL)


@pytest.mark.parametrize("log_bin,hierarchy", [(False, 2), (True, 2), (True, 3)])
def test_descriptors_match_jax(pair, log_bin, hierarchy):
    jext, text = pair
    x = _images(11, 48)
    want = np.asarray(jax.jit(lambda im: jext.extract_descriptors(im, layer=1, log_bin=log_bin,
                                                                  hierarchy=hierarchy))(jnp.asarray(x)))
    got = to_numpy(text.extract_descriptors(to_torch(x), layer=1, log_bin=log_bin, hierarchy=hierarchy))
    assert got.shape == want.shape == (2, 6, 6, 32 * ((1 + 8 * hierarchy) if log_bin else 1))
    assert_close_scaled(got, want, TOL)


def test_saliency_matches_jax(pair):
    jext, text = pair
    x = _images(12, 40)
    want = np.asarray(jax.jit(jext.extract_saliency_maps)(jnp.asarray(x)))
    got = to_numpy(text.extract_saliency_maps(to_torch(x)))
    assert got.shape == want.shape == (2, 5, 5)
    assert got.min() == 0.0 and got.max() == pytest.approx(1.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _dino_sd(seed, dim=32, depth=2, grid=4):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g) * 0.1  # noqa: E731
    sd = {"patch_embed.proj.weight": r(dim, 3, 8, 8), "patch_embed.proj.bias": r(dim),
          "pos_embed": r(1, grid * grid + 1, dim), "cls_token": r(1, 1, dim),
          "norm.weight": r(dim), "head.weight": r(10, dim)}  # the last two are not the extractor's
    for i in range(depth):
        for name, shape in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                            ("mlp.fc2", (dim, 4 * dim))):
            sd[f"blocks.{i}.{name}.weight"], sd[f"blocks.{i}.{name}.bias"] = r(*shape), r(shape[0])
        for name in ("norm1", "norm2"):
            sd[f"blocks.{i}.{name}.weight"], sd[f"blocks.{i}.{name}.bias"] = 1 + r(dim), r(dim)
    return sd


def _jax_loaded(path):
    """The tiny JAX extractor, seeded params (as `init` would set them), then
    its torch loader on `path`."""
    jext = jvit.ViTExtractor(weights_path=str(path))
    jext.vit = jvit.ViT(**TINY)
    jext.params = {"params": init_flax(jext.vit, jnp.zeros((1, 32, 32, 3)), seed=1)}
    jext._load_torch_weights(str(path))
    return jext


def test_dino_loader_matches_jax(tmp_path):
    """The same DINO checkpoint through both loaders gives the same features."""
    torch.save({"state_dict": _dino_sd(4)}, tmp_path / "dino.pth")
    jext = _jax_loaded(tmp_path / "dino.pth")
    vit = tvit.ViT(**TINY, seed=9)
    assert tvit.load_dino_weights(vit, tmp_path / "dino.pth") == 2 * 12 + 4
    text = object.__new__(tvit.ViTExtractor)
    text.vit, text.device = vit.eval(), torch.device("cpu")
    x = _images(13, 40)
    want = np.asarray(jax.jit(lambda im: jext.extract(im, layers=(1,), facet="token")[0])(jnp.asarray(x)))
    got = to_numpy(text.extract(to_torch(x), layers=(1,), facet="token")[0])
    assert_close_scaled(got, want, TOL)


def test_dino_loader_raises_on_a_shape(tmp_path):
    """The JAX loader keeps its init for a tensor of another shape; the port
    names the key and both shapes."""
    sd = _dino_sd(5)
    sd["pos_embed"] = torch.zeros(1, 26, 32)
    torch.save(sd, tmp_path / "bad.pth")
    jext = _jax_loaded(tmp_path / "bad.pth")
    assert np.asarray(jext.params["params"]["pos_embed"]).shape == (1, 17, 32)  # silently the init
    with pytest.raises(ValueError, match=r"pos_embed has shape \(1, 26, 32\), the extractor's pos_embed \(1, 17, 32\)"):
        tvit.load_dino_weights(tvit.ViT(**TINY), tmp_path / "bad.pth")


@pytest.mark.parametrize("channels", [1, 2, 3])
def test_dense_feature_fn_matches_jax(pair, channels):
    """Non-RGB images enter as their channel mean tiled to 3; the (B, 5, 5,
    32) map of a 40x40 image resized to the site grid 20x12."""
    jext, text = pair
    x = _images(20 + channels, 40, c=channels)
    want = np.asarray(jax.jit(jce.make_dense_feature_fn(jext, jext.params, (20, 12), layer=1))(jnp.asarray(x)))
    got = to_numpy(tce.make_dense_feature_fn(text, (20, 12), layer=1)(to_torch(x)))
    assert got.shape == want.shape == (2, 20, 12, 32)
    assert_close_scaled(got, want, TOL)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", [(1, 3, 5, 4), (1, 9, 2, 4), (2, 28, 28, 3)])
def test_jax_image_resize(method, shape):
    x = np.random.RandomState(len(shape)).randn(2, 6, 7, 4).astype(np.float32)
    target = (shape[0] * 2, *shape[1:3], 4)
    want = np.asarray(jax.image.resize(jnp.asarray(x), target, method))
    got = to_numpy(tvit.jax_image_resize(to_torch(x), target, method))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_extractor_build_and_facet_guard():
    """build_feature_cond_encoder's dino branch: ViT-S/8, frozen, seeded on
    the CPU (one seed, one extractor); an unknown facet raises."""
    ext, trainable = tce.build_feature_cond_encoder({"type": "dino"}, "cpu", seed=11)
    assert not trainable and isinstance(ext, tvit.ViTExtractor)
    assert (ext.vit.dim, ext.vit.depth, ext.vit.patch, ext.vit.pos_grid) == (384, 12, 8, 28)
    assert not any(p.requires_grad for p in ext.vit.parameters())
    again, _ = tce.build_feature_cond_encoder({"type": "dino"}, "cpu", seed=11)
    assert all(torch.equal(a, b) for a, b in zip(ext.vit.parameters(), again.vit.parameters()))
    with pytest.raises(ValueError, match="facet"):
        ext.extract(torch.zeros(1, 16, 16, 3), facet="value")
