"""PyTorch port: the whole UNet against the JAX package's, on the CPU.

Tolerances: fp32 within 5e-4 (relative and of the output scale: a whole
network sums in another order at every layer); bf16 within 3e-2 of the output
scale.  The 2D case at 32x32 with attention at ds 1 has T = 1024 sites, so
the port's T >= 512 flash dispatch is exercised (its plain version here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.nn.unet import UNet as TUNet
from jointimagegeneration_tpu.nn.unet import UNet

from test_torch_weights import assert_close_scaled, init_flax, jax_apply, load_port, to_numpy, to_torch

CASES = {  # name: (dims, spatial, x channels, cond channels, out channels, attention ds, softmax)
    "2d_32x32_attn_ds1": (2, (32, 32), 1, 2, 1, (1,), False),
    "3d_softmax": (3, (4, 8, 8), 4, 1, 4, (2,), True),
}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_unet_matches_jax(case, dt):
    dims, spatial, xc, cc, oc, attn, softmax = CASES[case]
    jdt, tdt = DTYPES[dt]
    kw = dict(model_channels=8, out_channels=oc, num_res_blocks=1, attention_resolutions=attn,
              channel_mult=(1, 2), dims=dims, num_head_channels=4, softmax_output=softmax)
    rs = np.random.RandomState(0)
    x = rs.randn(2, *spatial, xc).astype(np.float32)
    cond = rs.rand(2, *spatial, cc).astype(np.float32)
    t = np.array([3.0, 640.0], np.float32)
    net = UNet(dtype=jdt, **kw)
    p = init_flax(net, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond))
    want = np.asarray(jax_apply(net, p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond)))

    port = load_port(TUNet(in_channels=xc + cc, dtype=tdt, device="cpu", **kw), p)
    with torch.no_grad():
        got = port(to_torch(x), to_torch(t), cond=to_torch(cond))
    assert got.dtype == torch.float32  # fp32 head, fp32 input
    got = to_numpy(got)
    if softmax:
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    if dt == "fp32":
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * np.abs(want).max())
    else:
        assert_close_scaled(got, want, 3e-2)


def test_unet_rejects_unported_inputs():
    """`y` raises; `feature_cond` at a site the UNet was not widened for
    raises; a `context` is ignored without `context_dim`, as the flax UNet
    ignores it."""
    net = TUNet(in_channels=2, model_channels=8, out_channels=1, num_res_blocks=1,
                attention_resolutions=(2,), channel_mult=(1, 2), dims=2, device="cpu")
    x = torch.randn(1, 8, 8, 2)
    with pytest.raises(NotImplementedError):
        net(x, torch.zeros(1), y=torch.zeros(1, dtype=torch.long))
    with pytest.raises(ValueError, match="feature_cond sites"):
        net(x, torch.zeros(1), feature_cond={0: torch.zeros(1, 8, 8, 1)})
    with torch.no_grad():
        assert torch.equal(net(x, torch.zeros(1), context=torch.randn(1, 4, 8)), net(x, torch.zeros(1)))


def test_fresh_init_is_seeded_and_zero_inits_like_jax():
    kw = dict(in_channels=2, model_channels=8, out_channels=1, num_res_blocks=1,
              attention_resolutions=(2,), channel_mult=(1, 2), dims=2, device="cpu")
    a, b, c = TUNet(seed=5, **kw), TUNet(seed=5, **kw), TUNet(seed=6, **kw)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["in_conv.weight"], sc["in_conv.weight"])
    for k, v in sa.items():
        if k.endswith(("conv2_kernel", "proj_out.weight", "out_conv.weight", "bias")):
            assert not v.any(), k
    assert torch.equal(sa["out_norm.weight"], torch.ones(8))
