"""Image degradations for super-resolution training (numpy, cv2, scipy).

The port's copy of `jointimagegeneration_tpu/data/degradation.py`, with the
same random draws from the caller's `np.random.Generator` in the same order,
so an item degrades to the same bytes in both packages.  Two tiers, both on
[0, 1] float images:

  * `degradation_pipeline`: the light pipeline, its four steps (blur,
    downsample and back up, noise, JPEG) in a shuffled order, then an area
    downsample by `sf`;
  * `bsrgan_light_pipeline`: the BSRGAN-light schedule of the reference
    (`ldm/modules/image_degradation/bsrgan_light.py:442-620`): an optional
    pre-halving, seven shuffled slots with slot 2 forced before slot 3 and
    slot 3's target taken at slot-2 time (both quirks of the reference, kept),
    blur from the iso/aniso kernel zoo, light Gaussian noise, JPEG at p = 0.9
    and a final JPEG.

`get_degradation` picks one by the reference config's name.  cv2 and scipy are
imported inside the functions that use them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["degradation_pipeline", "gaussian_blur", "random_noise", "jpeg_compress", "downsample_up",
           "anisotropic_gaussian_kernel", "isotropic_gaussian_kernel", "sample_blur_kernel",
           "bsrgan_light_pipeline", "get_degradation"]


def gaussian_blur(img: np.ndarray, rng: np.random.Generator, sigma_range=(0.2, 2.0)) -> np.ndarray:
    import cv2

    sigma = float(rng.uniform(*sigma_range))
    k = max(3, int(sigma * 4) | 1)
    return cv2.GaussianBlur(img, (k, k), sigma).reshape(img.shape)


def random_noise(img: np.ndarray, rng: np.random.Generator, sigma_range=(0.0, 0.1)) -> np.ndarray:
    sigma = float(rng.uniform(*sigma_range))
    return np.clip(img + rng.normal(0, sigma, img.shape).astype(np.float32), 0, 1)


def jpeg_compress(img: np.ndarray, rng: np.random.Generator, quality_range=(30, 95)) -> np.ndarray:
    import cv2

    q = int(rng.integers(*quality_range))
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    _, enc = cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, q])
    dec = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
    return (dec.astype(np.float32) / 255.0).reshape(img.shape)


def downsample_up(img: np.ndarray, rng: np.random.Generator, scale_range=(1.5, 4.0)) -> np.ndarray:
    import cv2

    s = float(rng.uniform(*scale_range))
    h, w = img.shape[:2]
    small = cv2.resize(img, (max(1, int(w / s)), max(1, int(h / s))), interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR).reshape(img.shape)


def degradation_pipeline(img: np.ndarray, rng: np.random.Generator, sf: int = 4,
                         stages: Optional[Sequence[Callable]] = None) -> Tuple[np.ndarray, np.ndarray]:
    """HR [0, 1] (H, W, C) -> (LR degraded at H / sf, HR); the stages run in a
    shuffled order."""
    import cv2

    stages = list(stages or (gaussian_blur, downsample_up, random_noise, jpeg_compress))
    rng.shuffle(stages)
    lr = img.astype(np.float32)
    for f in stages:
        lr = f(lr, rng)
    h, w = img.shape[:2]
    lr = cv2.resize(lr, (w // sf, h // sf), interpolation=cv2.INTER_AREA).reshape((h // sf, w // sf) + img.shape[2:])
    return lr, img


# -- the BSRGAN-light kernel zoo (bsrgan_light.py:44-620) ---------------------------------------------


def anisotropic_gaussian_kernel(ksize: int, theta: float, l1: float, l2: float) -> np.ndarray:
    """The rotated Gaussian of the reference (anisotropic_Gaussian +
    gm_blur_kernel): covariance V diag(l1, l2) V^-1, V the reflection taking
    e_x to (cos theta, sin theta), evaluated on the grid centred at
    ksize / 2 + 0.5, normalised to sum 1."""
    v = np.array([np.cos(theta), np.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    sigma = V @ np.diag([float(l1), float(l2)]) @ np.linalg.inv(V)
    center = ksize / 2.0 + 0.5
    coords = np.arange(ksize) - center + 1
    cx, cy = np.meshgrid(coords, coords)  # k[y, x] = pdf([cx, cy])
    pts = np.stack([cx, cy], -1)
    quad = np.einsum("...i,ij,...j->...", pts, np.linalg.inv(sigma), pts)
    k = np.exp(-0.5 * quad)
    return k / k.sum()


def isotropic_gaussian_kernel(hsize: int, sigma: float) -> np.ndarray:
    """matlab fspecial('gaussian') (bsrgan_light.py:187-199)."""
    siz = (hsize - 1.0) / 2.0
    y, x = np.meshgrid(np.arange(-siz, siz + 1), np.arange(-siz, siz + 1))
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    s = h.sum()
    return h / s if s != 0 else h


def sample_blur_kernel(rng: np.random.Generator, sf: int = 4):
    """A blur kernel from the reference's add_blur draws (bsrgan_light.py:
    325-340): p = 0.5 anisotropic (ksize randint(2, 11) + 3, theta ~ U(0, pi),
    l1, l2 ~ (4 + sf) / 4 U(0, 1)), else isotropic (hsize randint(2, 4) + 3,
    sigma ~ (2 + 0.2 sf) / 4 U(0, 1)).  Returns (kernel, its parameters)."""
    wd2 = (4.0 + sf) / 4.0
    wd = (2.0 + 0.2 * sf) / 4.0
    if rng.random() < 0.5:
        l1 = wd2 * rng.random()
        l2 = wd2 * rng.random()
        p = {"kind": "aniso", "ksize": int(rng.integers(2, 12)) + 3,
             "theta": rng.random() * np.pi, "l1": max(l1, 1e-4), "l2": max(l2, 1e-4)}
        k = anisotropic_gaussian_kernel(p["ksize"], p["theta"], p["l1"], p["l2"])
    else:
        p = {"kind": "iso", "ksize": int(rng.integers(2, 5)) + 3, "sigma": max(wd * rng.random(), 1e-3)}
        k = isotropic_gaussian_kernel(p["ksize"], p["sigma"])
    return k, p


def _convolve_mirror(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    from scipy.ndimage import convolve

    return convolve(img, k[..., None] if img.ndim == 3 else k, mode="mirror")


def _shift_pixel(k: np.ndarray, sf: int) -> np.ndarray:
    """The kernel shifted by (sf - 1) / 2 pixels for scale-factor alignment
    (shift_pixel, bsrgan_light.py:102-128), renormalised."""
    from scipy.ndimage import map_coordinates

    shift = (sf - 1) * 0.5
    h, w = k.shape
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64), indexing="ij")
    out = map_coordinates(k, [yy + shift, xx + shift], order=1, mode="nearest")
    s = out.sum()
    return out / s if s > 0 else k


def _cv2_resize(img: np.ndarray, wh: Tuple[int, int], rng: np.random.Generator) -> np.ndarray:
    import cv2

    interp = int(rng.choice([1, 2, 3]))  # linear / cubic / area, as the reference draws
    w, h = max(1, wh[0]), max(1, wh[1])
    return cv2.resize(img, (w, h), interpolation=interp).reshape((h, w) + (img.shape[2:] if img.ndim == 3 else ()))


def _add_gaussian_noise_light(img: np.ndarray, rng: np.random.Generator, noise_level1: int = 1,
                              noise_level2: int = 2) -> np.ndarray:
    """add_Gaussian_noise (bsrgan_light.py:373-390) at the light levels:
    p > 0.6 per-channel noise, p < 0.4 one noise for all channels, else
    channel-correlated noise (per-channel when the image is not RGB)."""
    noise_level = int(rng.integers(noise_level1, noise_level2 + 1))
    rnum = rng.random()
    c = img.shape[2] if img.ndim == 3 else 1
    if rnum > 0.6 or (0.4 <= rnum <= 0.6 and c != 3):
        img = img + rng.normal(0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        shared = rng.normal(0, noise_level / 255.0, img.shape[:2]).astype(np.float32)
        img = img + (shared[..., None] if img.ndim == 3 else shared)
    else:
        from scipy.linalg import orth

        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = orth(rng.random((3, 3)))
        conv = U.T @ D @ U
        img = img + rng.multivariate_normal(np.zeros(3), np.abs(L ** 2 * conv), img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _add_jpeg_noise(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    import cv2

    q = int(rng.integers(80, 96))  # the reference's random.randint(80, 95)
    u8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    rgb = img.ndim == 3 and img.shape[2] == 3
    if rgb:  # cv2 encodes BGR; the reference converts both ways (bsrgan_light.py:422-428)
        u8 = u8[..., ::-1]
    _, enc = cv2.imencode(".jpg", u8, [int(cv2.IMWRITE_JPEG_QUALITY), q])
    dec = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
    if rgb:
        dec = dec[..., ::-1]
    return (dec.astype(np.float32) / 255.0).reshape(img.shape)


def bsrgan_light_pipeline(img: np.ndarray, rng: np.random.Generator, sf: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """HR [0, 1] (H, W[, C]) -> (LR at H / sf, the HR cropped to a multiple
    of sf): degradation_bsrgan_variant (bsrgan_light.py:540-620).  Slot 2
    (a random-ratio downsample, or the shifted-kernel nearest downsample) runs
    before slot 3 (the resize to the target recorded at slot-2 time); slots 1
    (a second blur) and 6 (the camera ISP) do nothing, as in the reference."""
    img = img.astype(np.float32)
    h1, w1 = img.shape[:2]
    img = img[: h1 - h1 % sf, : w1 - w1 % sf]
    h, w = img.shape[:2]
    hq = img.copy()
    sf_ori = sf

    if sf == 4 and rng.random() < 0.25:  # pre-halving
        img = _cv2_resize(img, (w // 2, h // 2), rng)
        sf = 2

    order = list(rng.permutation(7))
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:
        order[i2], order[i3] = order[i3], order[i2]

    a, b = img.shape[1], img.shape[0]  # the dims slot 3 targets
    for i in order:
        if i == 0:
            k, _ = sample_blur_kernel(rng, sf=sf)
            img = _convolve_mirror(img, k)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.8:
                sf1 = rng.uniform(1, 2 * sf)
                img = _cv2_resize(img, (int(img.shape[1] / sf1), int(img.shape[0] / sf1)), rng)
            else:
                k = isotropic_gaussian_kernel(25, rng.uniform(0.1, 0.6 * sf))
                img = _convolve_mirror(img, _shift_pixel(k, sf))
                img = img[0::sf, 0::sf]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            img = _cv2_resize(img, (int(a / sf), int(b / sf)), rng)
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = _add_gaussian_noise_light(img, rng)
        elif i == 5:
            if rng.random() < 0.9:
                img = _add_jpeg_noise(img, rng)

    img = _add_jpeg_noise(img, rng)
    target = (w // sf_ori, h // sf_ori)  # the variant can drift from the LR size by rounding
    if img.shape[:2] != (target[1], target[0]):
        img = _cv2_resize(img, target, rng)
    return np.clip(img, 0.0, 1.0), hq


def get_degradation(name: str) -> Callable:
    """The pipeline a reference config names (ldm/data/imagenet.py's
    degradation keys)."""
    if name in ("bsrgan_light", "bsrgan-light", "bsrgan"):
        return bsrgan_light_pipeline
    if name in ("light", "default", "pipeline"):
        return degradation_pipeline
    raise ValueError(f"unknown degradation {name!r}")
