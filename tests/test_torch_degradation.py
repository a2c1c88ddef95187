"""PyTorch port: the SR degradations (`data/degradation.py`) against the JAX package.

Every function on the same image under the same `np.random.default_rng`
seed, bit for bit: the output, and the generator's state after the call (one
more draw from each), so the port consumes the same draws in the same order.
Both pipelines in grey (H, W) or (H, W, 1) and RGB over enough seeds to take
every branch (the pre-halving, slot 2's two downsamples, the three noise
kinds, the p = 0.9 JPEG), the kernel zoo, the helpers, and
`get_degradation`'s names and its ValueError."""

import numpy as np
import pytest

from jointimagegeneration_torch.data import degradation as tdeg
from jointimagegeneration_tpu.data import degradation as jdeg


def _img(shape, seed=0):
    return np.random.default_rng(100 + seed).random(shape).astype(np.float32)


def _same(name, seed, *args, **kw):
    """Run `name` in both packages from default_rng(seed); assert equal
    outputs and generator states; return the port's output."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(jdeg, name)(*args, rj, **kw) if name not in NO_RNG else getattr(jdeg, name)(*args, **kw)
    got = getattr(tdeg, name)(*args, rt, **kw) if name not in NO_RNG else getattr(tdeg, name)(*args, **kw)
    for w, g in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
        if isinstance(w, dict):
            assert w == g
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype and np.asarray(g).shape == np.asarray(w).shape
            np.testing.assert_array_equal(g, w)
    assert rt.random() == rj.random()  # the same number of draws taken
    return got


NO_RNG = {"anisotropic_gaussian_kernel", "isotropic_gaussian_kernel", "_convolve_mirror", "_shift_pixel"}
SHAPES = [(24, 20, 3), (24, 20, 1), (24, 20)]


@pytest.mark.parametrize("shape", SHAPES, ids=["rgb", "grey1", "grey"])
@pytest.mark.parametrize("name", ["gaussian_blur", "random_noise", "jpeg_compress", "downsample_up"])
def test_light_steps(name, shape):
    if name == "jpeg_compress" and len(shape) == 3 and shape[2] == 1:
        shape = shape[:2]  # cv2 decodes a 1-channel JPEG as (H, W); the step reshapes it back
    for seed in range(3):
        _same(name, seed, _img(shape, seed))


@pytest.mark.parametrize("shape", [(32, 28, 3), (32, 28, 1)], ids=["rgb", "grey"])
def test_light_pipeline(shape):
    for seed in range(4):
        lr, hr = _same("degradation_pipeline", seed, _img(shape, seed), sf=4)
        assert lr.shape == (8, 7, shape[2]) and hr.shape == shape


def test_kernel_zoo():
    for ksize, theta, l1, l2 in ((7, 0.3, 1.2, 0.4), (15, 2.9, 0.01, 2.0), (4, 1.0, 0.7, 0.7)):
        k = _same("anisotropic_gaussian_kernel", 0, ksize, theta, l1, l2)
        assert k.shape == (ksize, ksize) and abs(k.sum() - 1) < 1e-12
    for hsize, sigma in ((5, 0.8), (25, 2.3), (6, 0.001)):
        _same("isotropic_gaussian_kernel", 0, hsize, sigma)
    kinds = set()
    for seed in range(12):
        for sf in (2, 4):
            kinds.add(_same("sample_blur_kernel", seed, sf=sf)[1]["kind"])
    assert kinds == {"aniso", "iso"}


@pytest.mark.parametrize("shape", SHAPES, ids=["rgb", "grey1", "grey"])
def test_helpers(shape):
    img = _img(shape, 1)
    k = tdeg.isotropic_gaussian_kernel(5, 1.1)
    np.testing.assert_array_equal(tdeg._convolve_mirror(img, k), jdeg._convolve_mirror(img, k))
    np.testing.assert_array_equal(tdeg._shift_pixel(tdeg.isotropic_gaussian_kernel(25, 1.5), 4),
                                  jdeg._shift_pixel(jdeg.isotropic_gaussian_kernel(25, 1.5), 4))
    for seed in range(4):
        _same("_cv2_resize", seed, img, (9, 13))
        _same("_add_jpeg_noise", seed, img if img.ndim == 2 or img.shape[2] == 3 else img[..., 0])
    branches = set()
    for seed in range(16):
        _same("_add_gaussian_noise_light", seed, img)
        r = np.random.default_rng(seed)
        r.integers(1, 3)
        u = r.random()
        branches.add("channel" if u > 0.6 else "shared" if u < 0.4 else "correlated")
    assert branches == {"channel", "shared", "correlated"}


@pytest.mark.parametrize("shape", [(48, 40, 3), (48, 40), (45, 42, 1)], ids=["rgb", "grey", "grey1-ragged"])
def test_bsrgan_light_pipeline(shape):
    halved = 0
    for seed in range(24):
        lr, hq = _same("bsrgan_light_pipeline", seed, _img(shape, seed), sf=4)
        h, w = shape[0] - shape[0] % 4, shape[1] - shape[1] % 4
        assert hq.shape[:2] == (h, w) and lr.shape[:2] == (h // 4, w // 4)
        assert lr.min() >= 0 and lr.max() <= 1
        r = np.random.default_rng(seed)
        halved += r.random() < 0.25
    assert 0 < halved < 24
    for seed in range(4):
        _same("bsrgan_light_pipeline", seed, _img(shape, seed), sf=2)


def test_get_degradation():
    for name in ("bsrgan_light", "bsrgan-light", "bsrgan"):
        assert tdeg.get_degradation(name) is tdeg.bsrgan_light_pipeline
        assert jdeg.get_degradation(name) is jdeg.bsrgan_light_pipeline
    for name in ("light", "default", "pipeline"):
        assert tdeg.get_degradation(name) is tdeg.degradation_pipeline
    for mod in (tdeg, jdeg):
        with pytest.raises(ValueError, match="unknown degradation 'cv_bicubic'"):
            mod.get_degradation("cv_bicubic")
    assert sorted(tdeg.__all__) == sorted(jdeg.__all__)
