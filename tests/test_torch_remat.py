"""PyTorch port: rematerialisation of the UNet's ResBlocks (`remat`,
`remat_levels`, `remat_policy`), against the port without remat and against
`jax.grad` of the JAX UNet with the same settings, on the CPU.

Tolerances: a recompute changes no forward value, so the port's loss with
every remat setting equals its loss without remat bit for bit, and its
gradients are within 1e-6 of each tensor's max (the backward may sum in
another order).  Against `jax.grad` of the JAX UNet (fp32) the gradients are
within 1e-5 of each tensor's max and the loss within 1e-5 (the frameworks sum
in another order).  Base 64, so that no GroupNorm group holds one channel:
a bias before such a group takes an exactly zero gradient, which the two
frameworks round to noise of either sign (the watch list).  The fused 'kernel' path (its convs are the plain version
on the CPU) is held against the port's fused path without remat; the JAX
package's fused path reaches its Pallas kernels, whose interpret mode is too
slow for a whole UNet's gradient here, and is not run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.nn.blocks import ResBlock
from jointimagegeneration_torch.nn.unet import UNet as TUNet
from jointimagegeneration_tpu.nn.unet import UNet

from test_torch_weights import init_flax, load_port, to_numpy, to_torch

KW = dict(model_channels=64, out_channels=3, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
          dims=3, num_head_channels=32)
SPATIAL = (2, 8, 16)
SETTINGS = {  # name: (remat, remat_levels, remat_policy)
    "full": (True, None, None),
    "levels": (True, (0,), None),
    "conv_outputs": (True, None, "conv_outputs"),
    "levels_conv_outputs": (True, (1,), "conv_outputs"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rs = np.random.RandomState(0)
    x = rs.randn(1, *SPATIAL, 2).astype(np.float32)
    t = np.array([321.0], np.float32)
    w = rs.randn(1, *SPATIAL, KW["out_channels"]).astype(np.float32)
    p = init_flax(UNet(**KW), jnp.asarray(x), jnp.asarray(t))
    return x, t, w, p, {}


def _port_loss_grads(p, x, t, w, fused=False, **remat):
    net = load_port(TUNet(in_channels=2, device="cpu", use_fused_resblock=fused, **KW, **remat), p)
    loss = (net(to_torch(x), to_torch(t)) * to_torch(w)).sum()
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, [q for _, q in net.named_parameters()])
    return float(loss.detach()), {n: to_numpy(g) for n, g in zip(names, grads)}


def _jax_loss_grads(setup, name):
    x, t, w, p, cache = setup
    if name not in cache:
        remat, levels, policy = SETTINGS.get(name, (False, None, None))
        net = UNet(remat=remat, remat_levels=levels, remat_policy=policy, **KW)

        def loss(params):
            return jnp.sum(net.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)) * jnp.asarray(w))

        cache[name] = jax.device_get(jax.jit(jax.value_and_grad(loss))(p))
    return cache[name]


def _close(got: dict, want: dict, frac: float):
    assert sorted(got) == sorted(want)
    for n, g in got.items():
        scale = max(np.abs(want[n]).max(), 1e-12)
        assert np.abs(g - want[n]).max() <= frac * scale, (n, np.abs(g - want[n]).max(), scale)


@pytest.mark.parametrize("fused", [False, "kernel"])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_remat_gives_the_no_remat_loss_and_gradients(setup, name, fused):
    x, t, w, p, _ = setup
    remat, levels, policy = SETTINGS[name]
    loss0, grads0 = _port_loss_grads(p, x, t, w, fused)
    loss, grads = _port_loss_grads(p, x, t, w, fused, remat=remat, remat_levels=levels, remat_policy=policy)
    assert loss == loss0
    _close(grads, grads0, 1e-6)


@pytest.mark.parametrize("name", ["off"] + sorted(SETTINGS))
def test_remat_gradients_match_jax_grad(setup, name):
    from jointimagegeneration_torch.utils.jax_weights import unet_state_dict_from_jax

    x, t, w, p, _ = setup
    remat, levels, policy = SETTINGS.get(name, (False, None, None))
    loss, grads = _port_loss_grads(p, x, t, w, remat=remat, remat_levels=levels, remat_policy=policy)
    jloss, jgrads = _jax_loss_grads(setup, name)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    _close(grads, {k: v.numpy() for k, v in unet_state_dict_from_jax(jgrads).items()}, 1e-5)


@pytest.mark.parametrize("remat", ["full", "conv_outputs"])
def test_dropout_draws_once_under_remat(remat):
    """A ResBlock with dropout 0.3 draws its keep mask once, before any
    checkpointed segment: the same output, gradients and noise-source
    position with remat on and off (a recompute draws nothing)."""
    torch.manual_seed(0)
    ref = ResBlock(8, 16, 32, 2, dropout=0.3, device="cpu")
    with torch.no_grad():
        for q in ref.parameters():
            q.normal_(0.0, 0.3)
    blk = ResBlock(8, 16, 32, 2, dropout=0.3, remat=remat, device="cpu")
    blk.load_state_dict(ref.state_dict())
    x, emb = torch.randn(2, 8, 8, 8), torch.randn(2, 32)
    outs = []
    for module in (ref, blk):
        noise = NoiseSource(5, "cpu")
        xg = x.clone().requires_grad_(True)
        y = module(xg, emb, noise)
        (gx,) = torch.autograd.grad((y * y).sum(), xg)
        outs.append((y.detach(), gx, noise.uniform((4,))))
    (y0, g0, next0), (y1, g1, next1) = outs
    assert torch.equal(y0, y1) and torch.equal(next0, next1)
    with torch.no_grad():
        assert not torch.equal(y0, ref(x, emb))  # the mask dropped something, through conv2
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6 * float(g0.abs().max()))
    with torch.no_grad():
        assert torch.equal(ref(x, emb), ref(x, emb, None))  # no noise source: no dropout


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        TUNet(in_channels=2, device="cpu", remat=True, remat_policy="dots", **KW)
    with pytest.raises(ValueError, match="remat"):
        ResBlock(8, 8, 32, 2, remat="everything", device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):  # as the JAX UNet's
        net = UNet(remat=True, remat_policy="dots", **KW)
        init_flax(net, jnp.zeros((1, *SPATIAL, 2)), jnp.zeros((1,)))


def test_remat_policy_reaches_every_resblock_of_its_levels():
    net = TUNet(in_channels=2, device="cpu", remat=True, remat_levels=(1,), remat_policy="conv_outputs", **KW)
    modes = {n: m.remat for n, m in net.named_modules() if isinstance(m, ResBlock)}
    assert modes == {"down_0_0_res": None, "down_1_0_res": "conv_outputs", "mid_res1": "conv_outputs",
                     "mid_res2": "conv_outputs", "up_1_0_res": "conv_outputs", "up_1_1_res": "conv_outputs",
                     "up_0_0_res": None, "up_0_1_res": None}
