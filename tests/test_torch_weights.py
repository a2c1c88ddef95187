"""PyTorch port: the JAX -> PyTorch weight bridge, plus helpers the other
`test_torch_*` files share (flax params with every leaf non-zero, loading
into a port module, noise replay, tolerance checks).

All port modules run on the CPU here (`device="cpu"`), so every kernel wrapper
takes its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.utils.jax_weights import flatten_tree, unet_state_dict_from_jax


# ---------------------------------------------------------------- helpers --

def init_flax(module, *args, seed: int = 0, **kw):
    """Numpy params (the 'params' collection) with the module's flax shapes,
    from `jax.eval_shape` (no init compile).  Every leaf carries signal:
    kernels N(0, 1/fan_in) (the zero-init ones too: conv2, proj_out,
    out_conv), norm scales 1 + N(0, 0.1^2), biases N(0, 0.05^2)."""
    shapes = jax.eval_shape(module.init, jax.random.key(seed), *args, **kw)["params"]
    rs = np.random.RandomState(seed + 1)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("kernel"):
            a = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name.endswith("scale"):
            a = 1.0 + 0.1 * rs.randn(*s.shape)
        else:
            a = 0.05 * rs.randn(*s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_apply(module, params, *args, **kw):
    """Jitted flax apply (one compile instead of eager per-op dispatch)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(params, *args)


def load_port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(unet_state_dict_from_jax(params))
    return module.eval()


def to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def assert_close_scaled(got, want, frac: float):
    """max |got - want| <= frac * max |want| (bf16 comparisons)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= frac * scale, f"max abs err {err} > {frac} x output scale {scale}"


class ReplayNoise:
    """A noise source that hands out prepared draws in order, checking the
    kind and the shape of each request."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        assert self.draws, f"no draw left for {kind}{tuple(shape)}"
        k, arr = self.draws.pop(0)
        assert k == kind and tuple(arr.shape) == tuple(shape), (k, arr.shape, kind, tuple(shape))
        return to_torch(arr)

    def normal(self, shape):
        return self._next("normal", shape)

    def gumbel(self, shape):
        return self._next("gumbel", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def randint(self, low, high, shape):
        assert self.draws, f"no draw left for randint{tuple(shape)}"
        k, arr = self.draws.pop(0)
        assert k == "randint" and tuple(arr.shape) == tuple(shape), (k, arr.shape, tuple(shape))
        assert low <= arr.min() and arr.max() < high, (arr, low, high)
        return torch.from_numpy(np.asarray(arr, np.int64))


def jax_mask_draws(key, shape, num_classes, n_steps):
    """The gumbel draws of MaskSampler.sample (mask_sampler.py:211-222;
    jax.random.categorical == argmax(logits + gumbel(key)))."""
    full = (*shape, num_classes)
    key, sub = jax.random.split(key)
    draws = [("gumbel", np.asarray(jax.random.gumbel(sub, full, jnp.float32)))]
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        draws.append(("gumbel", np.asarray(jax.random.gumbel(sub, full, jnp.float32))))
    return draws


def jax_volume_draws(key, b, d, h, w, c):
    """The x_T draws of SliceLDM.sample_volume (slice_ldm.py:549, :180-182),
    one per slice, for every sampler (the multistep ones draw x_T alike,
    :348-350).  Under warm start a later slice draws the q-noise of the
    previous raw slice instead, from the same key (:603-605), so the list
    is the same; guidance and tiling draw nothing; eta = 0 leaves no other
    noise."""
    draws = []
    for _ in range(d):
        key, sub = jax.random.split(key)
        _, sub2 = jax.random.split(sub)
        draws.append(("normal", np.asarray(jax.random.normal(sub2, (b, h, w, c)))))
    return draws


def jax_slice_draws(key, shape, n_steps, inpaint=False, eta=False):
    """The draws of one SliceLDM.sample_slice chain (slice_ldm.py:180-182,
    :205-211, ddim.py:99) in the port's order: x_T, then per step the
    inpainting noise before the model call and, with eta > 0, the DDIM noise
    after it."""
    key, sub = jax.random.split(key)
    draws = [("normal", np.asarray(jax.random.normal(sub, shape)))]
    for _ in range(n_steps):
        key, sub, sub2 = jax.random.split(key, 3)
        draws += [("normal", np.asarray(jax.random.normal(k, shape))) for k, on in ((sub2, inpaint), (sub, eta)) if on]
    return draws


def jax_ancestral_draws(key, shape, T):
    """The draws of SliceLDM._ancestral_loop (slice_ldm.py:260-276): x_T, then
    one normal per step for t = T-1 ... 0, t = 0 included."""
    key, sub = jax.random.split(key)
    draws = [("normal", np.asarray(jax.random.normal(sub, shape)))]
    for _ in range(T):
        key, sub = jax.random.split(key)
        draws.append(("normal", np.asarray(jax.random.normal(sub, shape))))
    return draws


def jax_log_images_draws(key, shape, n_steps, T, progressive=False):
    """The draws of SliceLDM.log_images (slice_ldm.py:417-446) from its five
    keys in order: the sample chain, inpaint, outpaint, the diffusion row's
    min(6, T) q_sample noises, and the progressive chain."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    draws = jax_slice_draws(k1, shape, n_steps)
    draws += jax_slice_draws(k2, shape, n_steps, inpaint=True) + jax_slice_draws(k3, shape, n_steps, inpaint=True)
    draws += [("normal", np.asarray(jax.random.normal(k, shape))) for k in jax.random.split(k4, min(6, T))]
    return draws + (jax_ancestral_draws(k5, shape, T) if progressive else [])


# ------------------------------------------------------------------ tests --

def test_bridge_layouts_from_nested_tree():
    rs = np.random.RandomState(0)
    r = lambda *s: rs.randn(*s).astype(np.float32)
    tree = {"params": {
        "in_conv": {"kernel": r(3, 3, 2, 5), "bias": r(5)},
        "time_embed_0": {"kernel": r(4, 6), "bias": r(6)},
        "down_0_0_res": {"conv1_kernel": r(3, 3, 3, 5, 7), "emb_kernel": r(6, 7),
                         "norm1_scale": r(5), "skip_kernel": r(1, 1, 1, 5, 7)},
        "mid_attn": {"norm": {"GroupNorm_0": {"scale": r(5), "bias": r(5)}}},
    }}
    sd = unet_state_dict_from_jax(tree)
    p = tree["params"]
    np.testing.assert_array_equal(sd["in_conv.weight"].numpy(), p["in_conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["time_embed_0.weight"].numpy(), p["time_embed_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["down_0_0_res.conv1_kernel"].numpy(),
                                  p["down_0_0_res"]["conv1_kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["down_0_0_res.emb_kernel"].numpy(), p["down_0_0_res"]["emb_kernel"].T)
    assert sd["down_0_0_res.skip_kernel"].shape == (7, 5, 1, 1, 1)
    np.testing.assert_array_equal(sd["down_0_0_res.norm1_scale"].numpy(), p["down_0_0_res"]["norm1_scale"])
    np.testing.assert_array_equal(sd["mid_attn.norm.weight"].numpy(), p["mid_attn"]["norm"]["GroupNorm_0"]["scale"])
    assert all(t.dtype == torch.float32 for t in sd.values())


def test_bridge_reads_flat_npz(tmp_path):
    rs = np.random.RandomState(1)
    tree = {"qkv": {"kernel": rs.randn(4, 12), "bias": rs.randn(12)},
            "up_1_us": {"conv": {"kernel": rs.randn(3, 3, 4, 4)}}}
    flat = {"/".join(k): v for k, v in flatten_tree(tree).items()}
    np.savez(tmp_path / "w.npz", **flat)
    from_npz = unet_state_dict_from_jax(tmp_path / "w.npz")
    from_tree = unet_state_dict_from_jax(tree)
    assert sorted(from_npz) == sorted(from_tree) == ["qkv.bias", "qkv.weight", "up_1_us.conv.weight"]
    for k in from_tree:
        np.testing.assert_array_equal(from_npz[k].numpy(), from_tree[k].numpy())


@pytest.mark.parametrize("dims", [2, 3])
def test_bridge_loads_whole_unet_strictly(dims):
    """Every flax parameter of a UNet lands on exactly one port parameter
    (load_state_dict is strict: no missing or unexpected keys)."""
    from jointimagegeneration_torch.nn.unet import UNet as TUNet
    from jointimagegeneration_tpu.nn.unet import UNet

    kw = dict(model_channels=8, out_channels=3, num_res_blocks=1, attention_resolutions=(2,),
              channel_mult=(1, 2), dims=dims, num_head_channels=4)
    spatial = (8,) * dims
    params = init_flax(UNet(**kw), jnp.zeros((1, *spatial, 2)), jnp.zeros((1,)),
                       cond=jnp.zeros((1, *spatial, 1)))
    port = TUNet(in_channels=3, device="cpu", **kw)
    load_port(port, params)
    n_flax = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    assert n_flax == sum(p.numel() for p in port.parameters())
