"""PyTorch port: stage-2 conditioning (the DiffusionWrapper modes 'concat',
'crossattn', 'hybrid' and 'adm') against the JAX package, on the CPU.

The 2D UNet with class ids (`adm_classes`, `label_emb`), with cross-attention
sites (`context_dim`) and with both, against the flax UNet; a context-free
`context_dim` UNet (the JAX CLIs' init, which passes no context shape)
against flax's lazily sized tree; every SliceLDM sampler route with
`context`, `y`, `uncond_context` and `guidance_scale` against the JAX one
with the JAX draws replayed (`ReplayNoise`); the stage-2 train step with a
context and with `class_label` against `jax.value_and_grad`; and
`cli.train_ldm` with the UNet's `num_classes` on a written `imagenet` tree.

Tolerances: the UNet forwards within 5e-4 of the output's scale (as
test_torch_unet.py); the fp32 chains within 2e-4 (as
test_torch_sampler_routes.py: both UNets sum in another order at every
step); the loss within 1e-5 relative and the gradients within 1e-4 of each
tensor's max (as test_torch_ldm_train.py); the CLI's first-step loss within
1e-5 relative (as test_torch_sr_train.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import train_ldm as tcli
from jointimagegeneration_torch.diffusion.ddim import DDIMParams as TDDIM
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.train import trainer as ttrainer
from jointimagegeneration_torch.train.steps import ldm_loss
from jointimagegeneration_torch.utils.jax_weights import unet_state_dict_from_jax
from jointimagegeneration_tpu.cli.common import build_slice_dataset as jbuild
from jointimagegeneration_tpu.cli.common import build_slice_ldm as jbuild_ldm
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM
from jointimagegeneration_tpu.train import losses as jlosses

from test_torch_ldm_train import _ldm_draws
from test_torch_weights import (ReplayNoise, init_flax, jax_ancestral_draws, jax_log_images_draws, jax_slice_draws,
                                jax_volume_draws, load_port, to_numpy, to_torch)

UNET = dict(model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,), num_res_blocks=1,
            num_head_channels=4)
S, CTX, CLASSES = 16, (5, 12), 3
MODES = {  # name: (cond channels, context_dim, adm_classes)
    "crossattn": (0, 12, None),
    "hybrid": (2, 12, None),
    "adm": (2, None, CLASSES),
    "hybrid_adm": (2, 12, CLASSES),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(mode: str, timesteps: int = 100, unet=UNET):
    cc, ctx_dim, adm = MODES[mode]
    js = SliceLDM.create(timesteps=timesteps, cond_channels=cc, context_dim=ctx_dim, adm_classes=adm, **unet)
    kw = dict(cond=jnp.zeros((1, S, S, cc)) if cc else None,
              context=jnp.zeros((1, *CTX)) if ctx_dim else None,
              y=jnp.zeros((1,), jnp.int32) if adm else None)
    p = init_flax(js.unet, jnp.zeros((1, S, S, 1)), jnp.zeros((1,)), **kw)
    ts = TSlice.create(timesteps=timesteps, cond_channels=cc, context_dim=ctx_dim, adm_classes=adm, device="cpu",
                       **unet)
    load_port(ts.unet, p)
    return js, {"params": p}, ts


@pytest.fixture(scope="module")
def pairs():
    return {m: _pair(m) for m in MODES}


def _inputs(mode: str, b: int = 2, seed: int = 0):
    cc, ctx_dim, adm = MODES[mode]
    rs = np.random.RandomState(seed)
    cond = rs.rand(b, S, S, cc).astype(np.float32) if cc else None
    ctx = rs.randn(b, *CTX).astype(np.float32) if ctx_dim else None
    y = rs.randint(0, CLASSES, (b,)).astype(np.int32) if adm else None
    return cond, ctx, y


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    if a is None:
        return None
    return torch.from_numpy(a.astype(np.int64)) if a.dtype.kind == "i" else to_torch(a)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_unet_modes_match_jax(pairs, mode):
    js, p, ts = pairs[mode]
    cond, ctx, y = _inputs(mode)
    x = np.random.RandomState(1).randn(2, S, S, 1).astype(np.float32)
    t = np.array([3, 71], np.int32)
    want = np.asarray(jax.jit(lambda *a: js.apply_model(p, *a[:2], cond=a[2], context=a[3], y=a[4]))(
        jnp.asarray(x), jnp.asarray(t), _j(cond), _j(ctx), _j(y)))
    with torch.no_grad():
        got = to_numpy(ts.apply_model(to_torch(x), _t(t), cond=_t(cond), context=_t(ctx), y=_t(y)))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * np.abs(want).max())
    if MODES[mode][2]:
        with pytest.raises(ValueError, match="class ids"):
            ts.apply_model(to_torch(x), _t(t), cond=_t(cond), context=_t(ctx))


def test_context_free_unet_matches_flax_lazy_init():
    """A `context_dim` UNet initialised without a context shape: flax sizes
    attn2's keys from the site's width; `context_free=True` builds that tree,
    and without a context both attend over x."""
    js = SliceLDM.create(timesteps=100, context_dim=12, **UNET)
    p = init_flax(js.unet, jnp.zeros((1, S, S, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, S, S, 2)))
    ts = TSlice.create(timesteps=100, context_dim=12, context_free=True, device="cpu", **UNET)
    load_port(ts.unet, p)
    with pytest.raises(ValueError, match="attn2"):  # the context-sized tree does not take it
        from jointimagegeneration_torch.utils.jax_weights import check_state

        check_state(dict(TSlice.create(timesteps=100, context_dim=12, device="cpu", **UNET).unet.named_parameters()),
                    unet_state_dict_from_jax(p), "lazy tree")
    x, cond = np.random.RandomState(2).randn(1, S, S, 1).astype(np.float32), np.random.RandomState(3).rand(
        1, S, S, 2).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, c: js.apply_model({"params": p}, a, jnp.array([9]), cond=c))(
        jnp.asarray(x), jnp.asarray(cond)))
    with torch.no_grad():
        got = to_numpy(ts.apply_model(to_torch(x), torch.tensor([9]), cond=to_torch(cond)))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4 * np.abs(want).max())


def _ddims(js, ts, steps=4):
    return DDIMParams.create(js.diffusion, steps), TDDIM.create(ts.diffusion, steps)


@pytest.mark.parametrize("guidance", [1.0, 2.0])
@pytest.mark.parametrize("mode", ["hybrid_adm", "crossattn"])
def test_sample_slice_matches_jax(pairs, mode, guidance):
    """DDIM with context, y and, under guidance, an `uncond_context` (the
    encoding of a padding prompt) for the unconditional branch."""
    js, p, ts = pairs[mode]
    cond, ctx, y = _inputs(mode, seed=4)
    b = 2
    cond = np.zeros((b, S, S, 0), np.float32) if cond is None else cond
    uctx = np.random.RandomState(5).randn(b, *CTX).astype(np.float32)
    jd, td = _ddims(js, ts)
    key = jax.random.key(3)
    want = np.asarray(js.sample_slice(p, key, jnp.asarray(cond), jd, context=_j(ctx), y=_j(y),
                                      guidance_scale=guidance, uncond_context=jnp.asarray(uctx)))
    noise = ReplayNoise(jax_slice_draws(key, (b, S, S, 1), 4))
    got = to_numpy(ts.sample_slice(noise, to_torch(cond), td, context=_t(ctx), y=_t(y), guidance_scale=guidance,
                                   uncond_context=to_torch(uctx)))
    assert not noise.draws
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("sampler", ["plms", "dpm"])
def test_multistep_routes_match_jax(pairs, sampler):
    js, p, ts = pairs["hybrid_adm"]
    cond, ctx, y = _inputs("hybrid_adm", seed=6)
    uctx = np.zeros((2, *CTX), np.float32)
    jd, td = _ddims(js, ts, 5)
    key = jax.random.key(4)
    want = np.asarray(js._sample_slice_multistep(p, key, jnp.asarray(cond), jd, sampler, context=_j(ctx), y=_j(y),
                                                 guidance_scale=2.0, uncond_context=jnp.asarray(uctx)))
    noise = ReplayNoise(jax_slice_draws(key, (2, S, S, 1), 0))
    fn = ts.sample_slice_plms if sampler == "plms" else ts.sample_slice_dpm
    got = to_numpy(fn(noise, to_torch(cond), td, context=_t(ctx), y=_t(y), guidance_scale=2.0,
                      uncond_context=to_torch(uctx)))
    assert not noise.draws
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("mode,guidance", [("hybrid_adm", 1.0), ("adm", 2.0)])
def test_sample_volume_matches_jax(pairs, mode, guidance):
    """The autoregressive volume with a context and class ids on every slice.
    The guided branch runs without a context, as the JAX volume's, which a
    context-sized attn2 of another width than its site's cannot take (in
    either package): guidance runs on the adm UNet here."""
    js, p, ts = pairs[mode]
    _, ctx, y = _inputs(mode, seed=7)
    mask = np.random.RandomState(8).rand(2, 3, S, S, 1).astype(np.float32)
    jd, td = _ddims(js, ts, 4)
    key = jax.random.key(6)
    want = np.asarray(js.sample_volume(p, key, jnp.asarray(mask), jd, context=_j(ctx), y=_j(y),
                                       guidance_scale=guidance))
    noise = ReplayNoise(jax_volume_draws(key, 2, 3, S, S, 1))
    got = to_numpy(ts.sample_volume(noise, to_torch(mask), td, context=_t(ctx), y=_t(y), guidance_scale=guidance))
    assert not noise.draws
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    stream = ReplayNoise(jax_volume_draws(key, 2, 3, S, S, 1))
    slices = list(ts.stream_volume(stream, to_torch(mask), td, context=_t(ctx), y=_t(y), guidance_scale=guidance))
    assert torch.equal(torch.stack(slices, 1), torch.from_numpy(got))


def test_ancestral_loops_match_jax():
    js, p, ts = _pair("hybrid_adm", timesteps=8)
    cond, ctx, y = _inputs("hybrid_adm", seed=9)
    key = jax.random.key(8)
    want, wrows = js.progressive_denoising(p, key, jnp.asarray(cond), context=_j(ctx), y=_j(y), n_rows=4)
    noise = ReplayNoise(jax_ancestral_draws(key, (2, S, S, 1), 8))
    got, rows = ts.progressive_denoising(noise, to_torch(cond), context=_t(ctx), y=_t(y), n_rows=4)
    assert not noise.draws
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(to_numpy(rows), np.asarray(wrows), atol=2e-4, rtol=2e-4)
    want = js.p_sample_loop(p, key, jnp.asarray(cond), context=_j(ctx), y=_j(y))
    noise = ReplayNoise(jax_ancestral_draws(key, (2, S, S, 1), 8))
    got = ts.p_sample_loop(noise, to_torch(cond), context=_t(ctx), y=_t(y))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("key_name", ["class_label", "y", None])
def test_log_images_takes_class_ids_from_the_batch(pairs, key_name):
    """`y` from batch['y'] or batch['class_label'] (zeros for an adm UNet
    with neither), as the JAX log_images."""
    js, p, ts = pairs["adm"]
    x = np.random.RandomState(10).rand(2, S, S, 1).astype(np.float32)
    cond, _, y = _inputs("adm", seed=11)
    jd, td = _ddims(js, ts, 4)
    key = jax.random.key(12)
    batch = {"image": x, "cond": cond}
    if key_name:
        batch[key_name] = y
    want = js.log_images(p, key, {k: jnp.asarray(v) for k, v in batch.items()}, jd, progressive=True)
    noise = ReplayNoise(jax_log_images_draws(key, (2, S, S, 1), 4, 100, progressive=True))
    got = ts.log_images(noise, {k: _t(v) for k, v in batch.items()}, td, progressive=True)
    assert not noise.draws and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=2e-4, rtol=2e-4, err_msg=k)


def test_train_step_with_context_and_class_label_matches_jax():
    """Base 64, as test_torch_ldm_train.py's step: at base <= 32 every
    GroupNorm group holds one channel and the bias before it takes an exactly
    zero gradient, whose rounding noise the frameworks do not share."""
    js, p, ts = _pair("hybrid_adm", unet=dict(model_channels=64, channel_mult=(1,), attention_resolutions=(1,),
                                              num_res_blocks=1, num_head_channels=16))
    cond, ctx, y = _inputs("hybrid_adm", seed=13)
    x0 = np.random.RandomState(14).rand(2, S, S, 1).astype(np.float32)
    key = jax.random.key(11)
    diff = js.diffusion

    def loss_fn(params):  # make_ldm_train_step's loss_fn (steps.py:88-100 there), y from class_label
        kt, kn = jax.random.split(key)
        t = jax.random.randint(kt, (2,), 0, diff.num_timesteps)
        noise = jax.random.normal(kn, x0.shape)
        out = js.apply_model(params, diff.q_sample(jnp.asarray(x0), t, noise), t, cond=jnp.asarray(cond),
                             context=jnp.asarray(ctx), y=jnp.asarray(y))
        return jlosses.gaussian_diffusion_loss(out, noise, t, diff.lvlb_weights, "l2")

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)
    noise = ReplayNoise(_ldm_draws(key, 2, 100, (2, S, S, 1)))
    batch = {"image": to_torch(x0), "cond": to_torch(cond), "context": to_torch(ctx), "class_label": _t(y)}
    loss, _ = ldm_loss(ts, noise, batch)
    assert not noise.draws
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    named = ts.named_parameters()
    grads = dict(zip([n for n, _ in named], torch.autograd.grad(loss, [q for _, q in named])))
    want = unet_state_dict_from_jax(jax.device_get(jgrads))
    assert sorted(grads) == sorted(want) and "label_emb.weight" in grads
    for n, g in grads.items():
        w = want[n].numpy()
        assert np.abs(to_numpy(g) - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-12), n


# -------------------------------------------------- the class-conditional CLI --

@pytest.fixture(scope="module")
def inet(tmp_path_factory):
    from test_torch_stock_data import _write_image

    root = tmp_path_factory.mktemp("inet_adm")
    for s, syn in enumerate(("n01440764", "n01443537", "n01484850")):
        for j in range(2):
            _write_image(root / syn / f"{syn}_{j}.JPEG", 40 + 5 * j, 44 - 3 * s, seed=10 * s + j)
    return root


def _adm_cfg(out, inet, **top) -> dict:
    """configs/stage2_ldm.yml with num_classes 3, RGB, no cond, the imagenet
    kind, cut to base 8 at 32x32, fp32."""
    import yaml

    from test_torch_sr_train import ROOT

    cfg = yaml.safe_load((ROOT / "configs" / "stage2_ldm.yml").read_text())
    cfg.update({"output_path": str(out), "batch_size": 2, "max_steps": 1, "display_freq": 1, "save_freq": 2,
                "eval_every": 2, "n_log_images": 2, "log_ddim_steps": 2, "num_workers": 1, "device": "cpu",
                "dataset": {"kind": "imagenet", "root": str(inet), "size": 32}, **top})
    cfg["model"].update(bf16=False, timesteps=100, channels=3, cond_channels=0)
    cfg["model"]["unet_config"]["params"] = {**UNET, "num_classes": CLASSES}
    return cfg


def test_cli_first_step_loss_matches_jax_with_class_ids(tmp_path, inet, monkeypatch):
    cfg = _adm_cfg(tmp_path / "runs", inet, validate=False)
    jm = jbuild_ldm(cfg["model"])
    assert jm.unet.adm_classes == CLASSES
    p = init_flax(jm.unet, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)), y=jnp.zeros((1,), jnp.int32), seed=2)
    ds = jbuild(cfg, "train")
    idx = np.random.default_rng(cfg["seed"]).permutation(len(ds))[:2]
    items = [ds[int(i)] for i in idx]
    x0 = jnp.asarray(np.stack([it["image"] for it in items]))
    y = jnp.asarray(np.array([it["class_label"] for it in items], np.int32))
    assert len(set(int(it["class_label"]) for it in ds)) == CLASSES
    key = jax.random.key(17)
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (2,), 0, 100)
    noise = jax.random.normal(kn, x0.shape, x0.dtype)
    out = jm.apply_model({"params": p}, jm.diffusion.q_sample(x0, t, noise), t, y=y)
    want = float(jlosses.gaussian_diffusion_loss(out, noise, t, jm.diffusion.lvlb_weights, "l2")[0])
    build = tcli.build_slice_ldm

    def build_with_jax_weights(*a, **kw):
        model = build(*a, **kw)
        load_port(model.unet, p)
        return model

    monkeypatch.setattr(tcli, "build_slice_ldm", build_with_jax_weights)
    replay = ReplayNoise(_ldm_draws(key, 2, 100, (2, 32, 32, 3)))
    monkeypatch.setattr(ttrainer, "NoiseSource", lambda seed, device: replay)
    tcli.run(cfg, "e1")
    assert not replay.draws
    recs = [json.loads(line) for line in (tmp_path / "runs" / "e1" / "metrics.jsonl").read_text().splitlines()]
    got = [r["train/loss"] for r in recs if "train/loss" in r]
    np.testing.assert_allclose(got, [want], rtol=1e-5)


def test_cli_trains_validates_and_resumes_class_conditional(tmp_path, inet, capsys):
    cfg = _adm_cfg(tmp_path / "runs", inet, max_steps=2)
    assert tcli.run(cfg, "e1").step == 2
    logdir = tmp_path / "runs" / "e1"
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in recs if "val/loss_simple" in r]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["val/loss_simple"])
    pngs = sorted(q.name for q in (logdir / "images").glob("*.png"))
    for panel in ("inputs", "samples", "inpaint", "outpaint"):
        assert any(panel in n for n in pngs), (panel, pngs)
    tcli.run({**cfg, "resume": True, "max_steps": 3}, "e1")
    assert "resumed from step 2" in capsys.readouterr().out
