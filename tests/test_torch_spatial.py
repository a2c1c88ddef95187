"""PyTorch port: the mesh's 'model' axis (`parallel/spatial.py`, `UNet(spatial_axis="model",
mesh=...)`) against the JAX package and the port's unsharded UNet, on the CPU.

The port's shards run on `["cpu"] * k`, the whole partitioned program in one
process (a mesh may repeat a device); the JAX package's sharded program runs
over its 8 virtual CPU devices (`tests/conftest.py`).  Tolerances: fp32
within rtol = atol = 1e-5, as the JAX package's own sharding test
(`tests/test_sharding.py:107`; every shard sums in another order: the
convs at other shapes, GroupNorm's statistics per shard then over the
shards); a sampled slice within 1e-4 (`:138`); sampled labels equal; bf16
within 3e-2 of the output scale, of the port's unsharded bf16 UNet and of the
fp32 JAX one (the bf16 UNet's tolerance in `tests/test_torch_unet.py`); gradients within 1e-5 of each tensor's max,
or of 1e-3 of the largest gradient where a tensor's own is rounding noise
(the attention's key bias, which softmax cancels)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from jointimagegeneration_torch.diffusion.ddim import DDIMParams as TDDIM
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.nn import blocks as tb
from jointimagegeneration_torch.nn import transformer as tt
from jointimagegeneration_torch.nn.unet import UNet as TUNet
from jointimagegeneration_torch.ops import attention as tattn
from jointimagegeneration_torch.parallel import spatial
from jointimagegeneration_torch.parallel.mesh import make_mesh
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM
from jointimagegeneration_tpu.nn.unet import UNet
from jointimagegeneration_tpu.parallel import make_mesh as jax_make_mesh

from test_torch_weights import (ReplayNoise, assert_close_scaled, init_flax, jax_apply, jax_mask_draws,
                                jax_slice_draws, load_port, to_numpy, to_torch)

TOL = 1e-5
# name: (dims, spatial, context width): self-attention sites (AttentionBlock) in 2D, SequenceTransformer
# sites over a context in 3D; every UNet base 8, mult (1, 2, 2), one ResBlock a level, attention at ds 1
# and 2: at 'model' = 8 level 0 has two planes a shard and level 1 would have one, too few for the
# Downsample after it, so levels 1-2 run gathered and split again on the way up
CONFIGS = {"2d": (2, (16, 16), None), "3d_context": (3, (16, 8, 8), 6)}
UNET_KW = dict(model_channels=8, num_res_blocks=1, channel_mult=(1, 2, 2), attention_resolutions=(1, 2),
               num_head_channels=4)
XC, CC, OC, CTX_LEN = 3, 2, 3, 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(model: int, data: int = 1):
    return make_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def _inputs(name: str):
    """(x, t, cond, context) of a CONFIGS entry, batch 2."""
    _, shape, ctx = CONFIGS[name]
    rs = np.random.RandomState(0)
    x = rs.randn(2, *shape, XC).astype(np.float32)
    cond = rs.rand(2, *shape, CC).astype(np.float32)
    context = None if ctx is None else rs.randn(2, CTX_LEN, ctx).astype(np.float32)
    return x, np.array([3.0, 640.0], np.float32), cond, context


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(flax params, inputs, the fp32 JAX output) of a CONFIGS entry."""
    dims, _, ctx = CONFIGS[name]
    inputs = _inputs(name)
    net = UNet(out_channels=OC, dims=dims, context_dim=ctx, **UNET_KW)
    jargs = tuple(jnp.asarray(a) for a in inputs if a is not None)
    p = init_flax(net, *jargs)
    return p, inputs, np.asarray(jax_apply(net, p, *jargs))


def _port(name: str, dt=torch.float32, **kw) -> TUNet:
    dims, _, ctx = CONFIGS[name]
    p, *_ = _case(name)
    return load_port(TUNet(in_channels=XC + CC, out_channels=OC, dims=dims, context_dim=ctx, dtype=dt, device="cpu",
                           **UNET_KW, **kw), p)


def _call(net, inputs):
    x, t, cond, context = inputs
    return net(to_torch(x), to_torch(t), cond=to_torch(cond), context=None if context is None else to_torch(context))


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_unet_matches_jax_and_unsharded(name, k):
    _, inputs, want = _case(name)
    net = _port(name)
    with torch.no_grad():
        plain = to_numpy(_call(net, inputs))
        net.set_mesh(_mesh(k), "model")
        got = to_numpy(_call(net, inputs))
    levels = net._sharded_levels(inputs[0].shape[1], k)
    assert levels == ([True, False, False] if k == 8 else [True, True, True])
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dims", [2, 3])
def test_feature_cond_split_at_sharded_sites(dims):
    """Dense features at the stem, a ResBlock and the down-transition
    (sites 0, 1 and 2), each split with the activation at its site."""
    shape = (16, 16) if dims == 2 else (16, 8, 8)
    widths = {0: 3, 1: 2, 2: 4}
    rs = np.random.RandomState(5)
    x = rs.randn(2, *shape, XC).astype(np.float32)
    t = np.array([7.0, 90.0], np.float32)
    fc = {i: rs.randn(2, *shape, f).astype(np.float32) for i, f in widths.items()}
    net = UNet(out_channels=OC, dims=dims, **UNET_KW)
    jfc = {i: jnp.asarray(v) for i, v in fc.items()}
    p = init_flax(net, jnp.asarray(x), jnp.asarray(t), feature_cond=jfc)
    want = np.asarray(jax_apply(net, p, jnp.asarray(x), jnp.asarray(t), feature_cond=jfc))
    port = load_port(TUNet(in_channels=XC, out_channels=OC, dims=dims, device="cpu", feature_cond_channels=widths,
                           **UNET_KW), p)
    tfc = {i: to_torch(v) for i, v in fc.items()}
    with torch.no_grad():
        plain = to_numpy(port(to_torch(x), to_torch(t), feature_cond=tfc))
        port.set_mesh(_mesh(4), "model")
        got = to_numpy(port(to_torch(x), to_torch(t), feature_cond=tfc))
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_attention_route_follows_the_sites_token_count(monkeypatch):
    """At 'model' = 4 the 3D level-0 sites (16x8x8 = 1,024 tokens) hold 256
    queries a shard, below FLASH_MIN_SEQ: their self- and cross-attention
    take the flash route (its plain version on the CPU) at the shard's shape,
    as the unsharded sites do."""
    calls = []
    flash = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention", lambda q, k, v: calls.append((q.shape, k.shape)) or flash(q, k, v))
    _, inputs, _ = _case("3d_context")
    net = _port("3d_context")
    with torch.no_grad():
        plain = to_numpy(_call(net, inputs))
        whole_calls, calls[:] = list(calls), []
        net.set_mesh(_mesh(4), "model")
        got = to_numpy(_call(net, inputs))
    assert tattn.FLASH_MIN_SEQ > 256
    shapes = lambda tq, tk: (torch.Size([2, 2, tq, 4]), torch.Size([2, 2, tk, 4]))
    # 1 down and 2 up sites, each attn1 over the site's 1,024 tokens and attn2 over the 5-token context
    assert whole_calls == [shapes(1024, 1024), shapes(1024, CTX_LEN)] * 3
    assert calls == ([shapes(256, 1024)] * 4 + [shapes(256, CTX_LEN)] * 4) * 3  # 4 shards at each
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)
    q, k = torch.randn(1, 2, 256, 4), torch.randn(1, 2, 1024, 4)
    calls[:] = []
    tattn.attention(q, k, k)
    assert not calls  # alone, 256 queries take the plain path
    tattn.attention(q, k, k, tq=1024)
    assert calls == [(q.shape, k.shape)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_gradients_match_unsharded(name):
    """64 channels at level 0, so that each of GroupNorm's 32 groups holds two
    and no gradient but the key bias's is zero in exact arithmetic (with one
    channel a group, GroupNorm cancels every per-channel shift: the time
    embedding's gradients are then rounding noise)."""
    from jointimagegeneration_torch.cli.common import fill_zero_init

    dims, _, ctx = CONFIGS[name]
    inputs = _inputs(name)
    net = TUNet(in_channels=XC + CC, out_channels=OC, dims=dims, context_dim=ctx, device="cpu",
                **{**UNET_KW, "model_channels": 64, "num_head_channels": 32})
    fill_zero_init(net, 0.05, 2)
    w = torch.from_numpy(np.random.RandomState(9).randn(*inputs[0].shape[:-1], OC).astype(np.float32))

    def grads():
        net.zero_grad()
        (_call(net, inputs) * w).sum().backward()
        return {n: p.grad.clone() for n, p in net.named_parameters()}

    plain = grads()
    net.set_mesh(_mesh(4), "model")
    got = grads()
    floor = 1e-3 * max(g.abs().max().item() for g in plain.values())
    for n, g in plain.items():
        err = (got[n] - g).abs().max().item()
        assert err <= TOL * max(g.abs().max().item(), floor), (n, err, g.abs().max().item())


def test_dropout_draws_the_whole_tensor():
    """A ResBlock's and a SequenceTransformer's dropout under sharding draw
    each mask once at the whole tensor's shape (ReplayNoise checks every
    request's shape) and keep the shard's part: the outputs are the whole
    tensor's under the same draws, and so are the gradients."""
    torch.manual_seed(0)
    res = tb.ResBlock(8, 16, 32, 3, dropout=0.3, device="cpu")
    st = tt.SequenceTransformer(16, 2, 8, depth=1, dropout=0.3, context_dim=6, device="cpu")
    for p in list(res.parameters()) + list(st.parameters()):
        torch.nn.init.normal_(p, 0.0, 0.2)
    x = torch.randn(2, 8, 4, 4, 8, requires_grad=True)
    emb, ctx = torch.randn(2, 32), torch.randn(2, 5, 6)
    rs = np.random.RandomState(1)
    draws = [("uniform", rs.rand(2, 8, 4, 4, 16).astype(np.float32))]  # the ResBlock's keep mask
    draws += [("uniform", rs.rand(2, 128, 16).astype(np.float32)) for _ in range(2)]  # attn1, attn2 outputs
    draws += [("uniform", rs.rand(2, 128, 64).astype(np.float32))]  # the feed-forward's hidden layer

    def run(sharded: bool):
        noise = ReplayNoise(draws)
        h = spatial.split(x, [torch.device("cpu")] * 4) if sharded else x
        out = st(res(h, emb, noise), ctx, noise)
        out = spatial.gather(out, torch.device("cpu")) if sharded else out
        assert not noise.draws
        (g,) = torch.autograd.grad(out.square().sum(), x)
        return out.detach(), g

    (want, gw), (got, gg) = run(False), run(True)
    with torch.no_grad():
        assert not torch.allclose(want, st(res(x, emb), ctx))  # the masks dropped values
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(gg, gw, rtol=TOL, atol=TOL)


def test_fused_xla_path_under_the_model_axis():
    """`use_fused_resblock='xla'` (batch 1, H % 8 == 0, so every ResBlock
    fuses): the fused blocks run whole on the first shard's device, the rest
    sharded; against the port's unsharded fused UNet."""
    kw = dict(in_channels=XC + CC, out_channels=OC, dims=3, device="cpu", use_fused_resblock="xla", **UNET_KW)
    net = TUNet(**kw)
    from jointimagegeneration_torch.cli.common import fill_zero_init

    fill_zero_init(net, 0.05, 3)
    x = torch.randn(1, 16, 8, 8, XC + CC)
    t = torch.tensor([11.0])
    with torch.no_grad():
        plain = net(x, t)
        net.set_mesh(_mesh(2), "model")
        got = net(x, t)
    assert net.down_0_0_res.can_fuse(x)
    torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)


def test_mask_sampler_with_spatial_axis_matches_jax():
    kw = dict(num_classes=4, time_steps=20, model_channels=8, channel_mult=(1, 2), attention_resolutions=(1,),
              num_res_blocks=1, num_head_channels=4)
    jm = MaskSampler.create(**kw)
    shape = (2, 8, 8, 8)
    p = init_flax(jm.unet, jnp.zeros((*shape, 4)), jnp.zeros((2,)), cond=jnp.zeros((*shape, 1)))
    tm = TMask.create(cond_channels=1, device="cpu", spatial_axis="model", mesh=_mesh(4), **kw)
    load_port(tm.unet, p)
    cond = np.random.RandomState(2).rand(*shape, 1).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jm.sample_labels({"params": p}, key, shape, cond=jnp.asarray(cond), num_steps=4))
    noise = ReplayNoise(jax_mask_draws(key, shape, 4, 4))
    with torch.no_grad():
        got = tm.sample_labels(noise, shape, cond=to_torch(cond), num_steps=4).numpy()
    assert not noise.draws and len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_slice_ldm_with_spatial_axis_matches_jax():
    """The JAX sharding test's slice chain (`tests/test_sharding.py:112-138`):
    DDIM-4 on a 16x16 slice, 'model' = 8, against the JAX unsharded chain."""
    kw = dict(timesteps=20, model_channels=8, channel_mult=(1, 2), attention_resolutions=(), num_res_blocks=1,
              num_head_channels=4)
    js = SliceLDM.create(**kw)
    p = init_flax(js.unet, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, 16, 16, 2)))
    ts = TSlice.create(device="cpu", spatial_axis="model", mesh=_mesh(8), **kw)
    load_port(ts.unet, p)
    cond = np.random.RandomState(1).randn(1, 16, 16, 2).astype(np.float32)
    key = jax.random.key(2)
    want = np.asarray(js.sample_slice({"params": p}, key, jnp.asarray(cond), DDIMParams.create(js.diffusion, 4)))
    noise = ReplayNoise(jax_slice_draws(key, (1, 16, 16, 1), 4))
    with torch.no_grad():
        got = to_numpy(ts.sample_slice(noise, to_torch(cond), TDDIM.create(ts.diffusion, 4)))
    assert not noise.draws
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_sharded_unet():
    """The bf16 UNet at 'model' = 4 against the port's unsharded bf16 UNet and
    the fp32 JAX one (the bf16 parity rule of the other port tests)."""
    name = "3d_context"
    _, inputs, want = _case(name)
    net = _port(name, torch.bfloat16)
    with torch.no_grad():
        plain = to_numpy(_call(net, inputs))
        net.set_mesh(_mesh(4), "model")
        got = to_numpy(_call(net, inputs))
    assert_close_scaled(got, plain, 3e-2)
    assert_close_scaled(got, want, 3e-2)


def test_matches_the_jax_sharded_program():
    """The JAX package's spatially sharded UNet at make_mesh(data=2, model=4)
    over its 8 virtual devices (`tests/test_sharding.py:86-107`) against the
    port's at the same mesh shape over 8 CPU shards: the batch's two rows
    over 'data', each row's H over 'model'."""
    kw = dict(model_channels=8, out_channels=2, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              dims=2, num_head_channels=4)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 16, 16, 2).astype(np.float32)
    t = np.array([3.0, 5.0], np.float32)
    m = UNet(**kw, spatial_axis="model")
    p = init_flax(m, jnp.asarray(x), jnp.asarray(t))
    mesh = jax_make_mesh(data=2, model=4)
    with mesh:
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", "model")))
        ps = jax.device_put(p, NamedSharding(mesh, P()))
        want = np.asarray(jax.jit(lambda pp, a, b: m.apply({"params": pp}, a, b))(ps, xs, jnp.asarray(t)))
    port = load_port(TUNet(in_channels=2, device="cpu", spatial_axis="model", mesh=_mesh(4, data=2), **kw), p)
    with torch.no_grad():
        got = to_numpy(port(to_torch(x), to_torch(t)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_spatial_axis_and_mesh_errors():
    kw = dict(in_channels=2, model_channels=8, out_channels=1, num_res_blocks=1, attention_resolutions=(),
              channel_mult=(1, 2), dims=2, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        TUNet(spatial_axis="model", **kw)
    with pytest.raises(ValueError, match="'model' axis"):
        TUNet(spatial_axis="data", mesh=_mesh(2), **kw)
    with pytest.raises(ValueError, match="spatial_axis='model'"):
        TUNet(mesh=_mesh(2), **kw)
    with pytest.raises(ValueError, match="equal shards"):
        spatial.split(torch.zeros(1, 6, 2), [torch.device("cpu")] * 4)
    net = TUNet(mesh=make_mesh(data=2, devices=["cpu", "cuda:1"]), **kw)  # a row on another device
    with pytest.raises(ValueError, match="without autograd"):
        net(torch.zeros(2, 8, 8, 2), torch.zeros(2))
