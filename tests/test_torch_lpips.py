"""PyTorch port: LPIPS and its three-view volume mean against the JAX package.

The JAX LPIPS' VGG16 parameters carried over by `lpips_state_dict_from_jax`,
with and without the learned lin heads, at 32 px (so the resize to 64 runs)
and at 64 px; the resize itself against `jax.image.resize(..., "linear")`;
the `.npz` and torch-checkpoint loaders against the JAX loaders.  fp32:
distances within 1e-4 of their size (13 convs summing in another order),
the resize within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jointimagegeneration_torch.eval import lpips as tl
from jointimagegeneration_torch.utils.jax_weights import lpips_state_dict_from_jax
from jointimagegeneration_tpu.eval import lpips as jl

from test_torch_weights import to_numpy, to_torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lins(seed):
    rs = np.random.RandomState(seed)
    return {k: np.abs(rs.randn(c)).astype(np.float32) for k, c in enumerate((64, 128, 256, 512, 512))}


@pytest.fixture(scope="module")
def metric_pair():
    """The JAX metric (its own init) and the port's with the same VGG params."""
    jm = jl.LPIPS()
    tm = tl.LPIPS(device="cpu")
    tm.net.load_state_dict(lpips_state_dict_from_jax(jax.device_get(jm.params)))
    return jm, tm


def _pair(seed, *shape):
    rs = np.random.RandomState(seed)
    return rs.rand(*shape).astype(np.float32), rs.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("lins", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 32, 1), (1, 64, 64, 3), (1, 40, 70, 1)])
def test_lpips_matches_jax(metric_pair, shape, lins):
    jm, tm = metric_pair
    if lins:
        heads = _lins(1)
        jm.lin_weights = [jnp.asarray(heads[k]) for k in sorted(heads)]
        tm.install({}, {}, heads)
    a, b = _pair(2, *shape)
    want = np.asarray(jm(jnp.asarray(a), jnp.asarray(b)))
    got = to_numpy(tm(to_torch(a), to_torch(b)))
    jm.lin_weights = tm.lin_weights = None
    assert got.shape == (shape[0],) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert float(tm(to_torch(a), to_torch(a)).max()) == 0.0


@pytest.mark.parametrize("hw,out", [((32, 32), (64, 64)), ((5, 7), (64, 64)), ((40, 100), (64, 100)),
                                    ((64, 20), (64, 64))])
def test_resize_is_jax_linear(hw, out):
    """Upsampling, jax.image.resize 'linear' is bilinear with half-pixel
    centres: F.interpolate(align_corners=False); an axis at its size stays."""
    x = np.random.RandomState(3).rand(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out, 3), "linear"))
    got = F.interpolate(to_torch(x).permute(0, 3, 1, 2), size=out, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(to_numpy(got.permute(0, 2, 3, 1)), want, atol=1e-6, rtol=0)


def test_three_view_matches_jax(metric_pair):
    jm, tm = metric_pair
    a, b = _pair(4, 6, 32, 40)
    want = float(jl.lpips_three_view(jm, jnp.asarray(a), jnp.asarray(b)))
    got = float(tl.lpips_three_view(tm, to_torch(a), to_torch(b)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _torchvision_sd(seed):
    """A torchvision-layout VGG16 `features` state dict (convs at the
    Sequential's slots 0, 2, 5, 7, 10, ...), random."""
    g = torch.Generator().manual_seed(seed)
    sd, slot, cin = {}, 0, 3
    for v in jl._VGG_CFG:
        if v == "M":
            slot += 1
            continue
        sd[f"features.{slot}.weight"] = torch.randn(v, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5
        sd[f"features.{slot}.bias"] = 0.01 * torch.randn(v, generator=g)
        slot, cin = slot + 2, v
    return sd


def test_torch_checkpoint_loader_matches_jax(tmp_path):
    """A torchvision VGG16 checkpoint and an LPIPS lin-head checkpoint load
    into both metrics alike (convs in sorted slot order)."""
    torch.save(_torchvision_sd(5), tmp_path / "vgg16.pth")
    g = torch.Generator().manual_seed(6)
    torch.save({f"lin{k}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
                for k, c in enumerate((64, 128, 256, 512, 512))}, tmp_path / "lins.pth")
    a, b = _pair(7, 1, 32, 32, 1)
    outs = []
    for metric in (jl.LPIPS(str(tmp_path / "vgg16.pth")), tl.LPIPS(str(tmp_path / "vgg16.pth"), device="cpu")):
        (metric.load if isinstance(metric, tl.LPIPS) else metric._load_torch_weights)(str(tmp_path / "lins.pth"))
        assert metric.lin_weights is not None and len(metric.lin_weights) == 5
        outs.append(np.asarray(metric(*((jnp.asarray if isinstance(metric, jl.LPIPS) else to_torch)(v)
                                        for v in (a, b)))))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4)
    port = tl.LPIPS(str(tmp_path / "vgg16.pth"), device="cpu")
    np.testing.assert_array_equal(port.net.conv2.weight.detach().numpy(), _torchvision_sd(5)["features.5.weight"].numpy())


def test_npz_loader_matches_jax(tmp_path):
    """The `.npz` of scripts/convert_lpips_weights.py: conv_<i>_kernel (HWIO),
    conv_<i>_bias, lin_<k>."""
    sd = _torchvision_sd(8)
    conv_w, conv_b, _ = tl.parse_torch_lpips_sd({k: v.numpy() for k, v in sd.items()})
    out = {f"conv_{i}_kernel": np.transpose(w, (2, 3, 1, 0)) for i, w in conv_w.items()}
    out.update({f"conv_{i}_bias": b for i, b in conv_b.items()})
    out.update({f"lin_{k}": v for k, v in _lins(9).items()})
    np.savez(tmp_path / "lpips.npz", **out)
    jm, tm = jl.LPIPS(str(tmp_path / "lpips.npz")), tl.LPIPS(str(tmp_path / "lpips.npz"), device="cpu")
    a, b = _pair(10, 1, 48, 48, 3)
    np.testing.assert_allclose(to_numpy(tm(to_torch(a), to_torch(b))), np.asarray(jm(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4)
    np.testing.assert_array_equal(tm.net.conv12.bias.detach().numpy(), conv_b[12])


def test_uncalibrated_default_is_a_valid_metric():
    """Without weights: the port's own seeded init, zero for equal inputs,
    symmetric, the same for the same seed."""
    a, b = _pair(11, 1, 32, 32, 1)
    m1, m2 = tl.LPIPS(device="cpu"), tl.LPIPS(device="cpu")
    d = m1(to_torch(a), to_torch(b))
    assert float(d) > 0 and torch.equal(d, m1(to_torch(b), to_torch(a)))
    assert torch.equal(d, m2(to_torch(a), to_torch(b)))
    assert float(m1.net.conv0.bias.detach().abs().max()) == 0.0
