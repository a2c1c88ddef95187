"""PyTorch port: text-conditioned stage-1 training against the JAX package, on
the CPU: the loss and every gradient (the UNet's and the refiner's) with the
refiner's dropout at 0, the dropout rules, the `{"unet", "refiner"}` weight
and train-state bridge, and the `train_mask` CLI with `selfattn`.

The JAX draws (t, then x_t) are replayed.  Dropout cannot replay flax's
per-module dropout keys, so the parity runs take it at 0; its rule is held
against `jax.random.bernoulli`, the draw flax's `nn.Dropout` makes.
Tolerances, as `test_torch_train.py`: fp32 loss and every gradient within
1e-4 of the tensor's max |.|; params and EMA after a bridged step 1e-5
relative plus 2e-6 absolute (Adam's bias corrections, see that file).  bf16,
against the JAX *fp32* values: the loss within 1e-3, each gradient within
3e-2 of its max, or within 1.5 x the JAX bf16 gradient's own distance from
the fp32 one where that is larger.  The JAX bf16 run is no yardstick here:
its loss is 1.02e-3 off its own fp32 loss (the port's 4.0e-5), and its
gradients up to 7.1% of a tensor's max; the refiner's see the UNet only
through the bf16-rounded context, and the port's worst leaf is 3.7% off
where the JAX bf16 one is 4.1% (measured, key 13)."""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import train_mask as tcli
from jointimagegeneration_torch.core.checkpoint import CheckpointManager
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.nn.transformer import dropout
from jointimagegeneration_torch.train.optim import build_optimizer as t_opt
from jointimagegeneration_torch.train.state import EMATrainState as TState
from jointimagegeneration_torch.train.steps import make_mask_train_step as t_step, mask_loss
from jointimagegeneration_torch.utils.jax_weights import train_state_from_jax, unet_state_dict_from_jax
from jointimagegeneration_tpu.data.datasets import SyntheticMaskDataset
from jointimagegeneration_tpu.models.common import unet_vars
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler
from jointimagegeneration_tpu.train import losses as jlosses
from jointimagegeneration_tpu.train.optim import build_optimizer
from jointimagegeneration_tpu.train.state import EMATrainState
from jointimagegeneration_tpu.train.steps import make_mask_train_step

from test_torch_weights import ReplayNoise, init_flax, to_numpy, to_torch

# base 64 for the reason test_torch_train.py gives; 8x8x8 puts 512 query
# tokens at the ds-1 and mid sites, so self- and cross-attention take the
# flash rule (its plain version here), the latter over a 5-token context
UNET = dict(num_classes=4, time_steps=20, model_channels=64, channel_mult=(1,), attention_resolutions=(1,),
            num_res_blocks=1, num_head_channels=16)
SHAPE, CTX = (1, 8, 8, 8), (5, 24)
REFINER = {"type": "selfattn", "embed_dim": 24, "n_heads": 2, "d_head": 8, "model_depth": 2, "dropout": 0.0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaled(got, want, frac, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * scale, f"{what}: max abs err {err} > {frac} x max {scale}"


def _draws(key, x0_shape):
    """The JAX step's draws (steps.py:46-48): t, then x_t; none for dropout 0."""
    kt, kx, _ = jax.random.split(key, 3)
    return [("gumbel", np.asarray(jax.random.gumbel(kt, (1, 20), jnp.float32))),
            ("gumbel", np.asarray(jax.random.gumbel(kx, x0_shape, jnp.float32)))]


@pytest.fixture(scope="module")
def setup():
    """JAX text samplers (fp32, bf16), their {"unet", "refiner"} tree and a
    batch with a context."""
    jm32 = MaskSampler.create(context_dim=24, text_refiner=REFINER, **UNET)
    jm16 = MaskSampler.create(context_dim=24, text_refiner=REFINER, dtype=jnp.bfloat16, **UNET)
    rs = np.random.RandomState(3)
    ctx = rs.randn(1, *CTX).astype(np.float32)
    pu = init_flax(jm32.unet, jnp.zeros((*SHAPE, 4)), jnp.zeros((1,)), cond=jnp.zeros((*SHAPE, 1)),
                   context=jnp.asarray(ctx))
    pr = init_flax(jm32.refiner, jnp.asarray(ctx), seed=5)
    item = SyntheticMaskDataset(num_cases=1, volume_shape=SHAPE[1:], num_classes=4)[0]
    batch = {"mask": item["mask"][None], "image": rs.rand(*SHAPE, 1).astype(np.float32), "context": ctx}
    return {"float32": jm32, "bfloat16": jm16}, {"unet": {"params": pu}, "refiner": {"params": pr}}, batch


def _port(tree, dtype, dropout_rate=0.0):
    tm = TMask.create(cond_channels=1, dtype=dtype, device="cpu", context_dim=24,
                      text_refiner={**REFINER, "dropout": dropout_rate}, **UNET)
    state = unet_state_dict_from_jax(tree)
    named = dict(tm.named_parameters())
    assert sorted(state) == sorted(named)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(state[n])
    return tm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_text_loss_and_grads_match_jax(setup, dtype):
    """make_mask_train_step's loss_fn with a context: the refiner inside the
    loss, so its parameters (and attn2's to_k / to_v, the only path from the
    UNet into it) get gradients."""
    jms, tree, batch = setup
    bf16 = dtype == torch.bfloat16
    cw = jnp.asarray([0.5, 1.0, 2.0, 1.5])
    key = jax.random.key(13)
    x0, cond, ctx = (jnp.asarray(batch[k]) for k in ("mask", "image", "context"))

    def value_and_grad(jm):
        diff = jm.diffusion

        def loss_fn(params):
            kt, kx, kd = jax.random.split(key, 3)
            t = jlosses.sample_train_timesteps(kt, 1, diff.time_steps)
            xt = diff.sample_q_xt_given_x0(kx, x0, t)
            context = jm.refine_context(params, ctx, rng=kd)
            x0pred = jm.unet.apply(unet_vars(params), xt, t.astype(jnp.float32), cond=cond, context=context)
            return jlosses.categorical_diffusion_loss(diff.theta_post(xt, x0, t),
                                                      diff.theta_post_prob(xt, x0pred, t), x0, x0pred, cw)

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)

    (jloss, jmetrics), jgrads = value_and_grad(jms["float32"])
    want = unet_state_dict_from_jax(jax.device_get(jgrads))
    limits = {n: 1e-4 for n in want}
    if bf16:  # each leaf: 3e-2, or 1.5 x the JAX bf16 gradient's own distance from the fp32 one
        jax16 = unet_state_dict_from_jax(jax.device_get(value_and_grad(jms["bfloat16"])[1]))
        limits = {n: max(3e-2, 1.5 * np.abs(jax16[n].numpy() - w.numpy()).max() / np.abs(w.numpy()).max())
                  for n, w in want.items()}
    tm = _port(tree, dtype)
    noise = ReplayNoise(_draws(key, x0.shape))
    loss, metrics = mask_loss(tm, noise, {k: to_torch(v) for k, v in batch.items()}, to_torch(np.asarray(cw)))
    assert not noise.draws
    named = tm.named_parameters()
    grads = dict(zip([n for n, _ in named], torch.autograd.grad(loss, [p for _, p in named])))
    assert sorted(want) == sorted(grads) and any(n.startswith("refiner.") for n in grads)
    loss_tol = 1e-3 if bf16 else 1e-4
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=loss_tol)
    for k in ("loss_kl", "loss_ce"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=loss_tol)
    for n, g in grads.items():
        _scaled(to_numpy(g), want[n].numpy(), limits[n], n)
    assert np.abs(to_numpy(grads["refiner.block_0.attn1.to_q.weight"])).max() > 0
    assert np.abs(to_numpy(grads["mid_attn.block_0.attn2.to_k.weight"])).max() > 0


def test_dropout_rule_is_flax_bernoulli():
    """keep = uniform < 1 - p (jax.random.bernoulli's draw), kept values
    scaled by 1 / (1 - p), zeros elsewhere; the identity without a noise
    source or at rate 0 (no draw)."""
    x = np.random.RandomState(0).randn(4, 64, 16).astype(np.float32)
    key = jax.random.key(2)
    keep = np.asarray(jax.random.bernoulli(key, 0.8, x.shape))
    want = np.where(keep, x / np.float32(0.8), 0)
    got = dropout(to_torch(x), 0.2, ReplayNoise([("uniform", np.asarray(jax.random.uniform(key, x.shape)))]))
    np.testing.assert_array_equal(to_numpy(got), want)
    flax_out = np.asarray(fnn.Dropout(0.2).apply({}, jnp.asarray(x), deterministic=False, rngs={"dropout": key}))
    kept = flax_out != 0
    np.testing.assert_allclose(flax_out[kept], x[kept] / 0.8, rtol=1e-6)  # flax's own rule, other keys
    assert abs(kept.mean() - 0.8) < 0.02
    for noise, rate in ((None, 0.2), (ReplayNoise([]), 0.0)):
        np.testing.assert_array_equal(to_numpy(dropout(to_torch(x), rate, noise)), x)
    assert not dropout(to_torch(x), 1.0, NoiseSource(0, "cpu")).any()


def test_dropout_in_training_only(setup):
    """With dropout 0.2 the refiner draws one uniform mask per attn1, attn2
    and feed-forward hidden layer of each block, in that order, at training;
    none at sampling (refine_context without a noise source is deterministic)
    and none in the validation sample."""
    _, tree, batch = setup
    tm = _port(tree, torch.float32, dropout_rate=0.2)
    ctx = to_torch(batch["context"])
    shapes = []

    class Recording(NoiseSource):
        def uniform(self, shape):
            shapes.append(tuple(shape))
            return super().uniform(shape)

    with torch.no_grad():
        a, b = tm.refine_context(ctx), tm.refine_context(ctx)
        c = tm.refine_context(ctx, Recording(0, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert shapes == [(1, 5, 24), (1, 5, 24), (1, 5, 96)] * 2
    shapes.clear()
    loss, _ = mask_loss(tm, Recording(1, "cpu"), {k: to_torch(v) for k, v in batch.items()})
    assert torch.isfinite(loss) and len(shapes) == 6
    shapes.clear()
    tm.sample_labels(Recording(2, "cpu"), SHAPE, cond=to_torch(batch["image"]), context=ctx, num_steps=2)
    assert shapes == []


def _jax_train(jm, tree, batch, keys, n):
    tx = build_optimizer("AdamW", 1e-3, "polynomial", {"power": 1.0, "min_lr": 1e-6}, total_steps=10)
    state = EMATrainState.create(jax.tree.map(jnp.asarray, tree), tx, ema_decay=0.9)
    step = jax.jit(make_mask_train_step(jm, jnp.ones((4,))))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(n):
        state, _ = step(state, jb, keys[i])
    return state, step


def test_train_state_bridge_with_refiner(setup):
    """Two JAX steps of the text step, the state carried over with
    train_state_from_jax (the {"unet", "refiner"} trees of params, EMA and
    AdamW's moments), then a third step on both sides."""
    jms, tree, batch = setup
    jm = jms["float32"]
    keys = jax.random.split(jax.random.key(6), 3)
    jstate, jstep = _jax_train(jm, tree, batch, keys, 2)
    host = jax.device_get(jstate)
    sd = train_state_from_jax(host.params, host.ema_params, host.opt_state, step=int(host.step))
    assert sd["optimizer"]["count"] == 2 and any(n.startswith("refiner.") for n in sd["params"])
    tm = _port(tree, torch.float32)
    opt = t_opt(tm.named_parameters(), "AdamW", 1e-3, "polynomial", {"power": 1.0, "min_lr": 1e-6}, total_steps=10)
    tstate = TState(opt, ema_decay=0.9)
    tstate.load_state_dict(sd)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, keys[2])
    noise = ReplayNoise(_draws(keys[2], batch["mask"].shape))
    metrics = t_step(tm, torch.ones(4))(tstate, {k: to_torch(v) for k, v in batch.items()}, noise)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-4)
    assert tstate.step == 3 and tstate.optimizer.count == 3
    want_p = unet_state_dict_from_jax(jax.device_get(jstate.params))
    want_e = unet_state_dict_from_jax(jax.device_get(jstate.ema_params))
    for (n, prm), e in zip(tm.named_parameters(), tstate.ema):
        np.testing.assert_allclose(to_numpy(prm), want_p[n].numpy(), atol=2e-6, rtol=1e-5, err_msg=n)
        np.testing.assert_allclose(to_numpy(e), want_e[n].numpy(), atol=2e-6, rtol=1e-5, err_msg=n)


def _cli_cfg(out, **kw):
    cfg = {"output_path": str(out), "seed": 0, "num_classes": 4, "time_steps": 20, "bf16": False, "batch_size": 1,
           "max_steps": 4, "save_freq": 2, "display_freq": 1, "validation_freq_steps": 4, "eval_time_steps": 2,
           "n_validation_images": 1, "device": "cpu",
           "optim": {"name": "AdamW", "learning_rate": 1e-3, "lr_function": "polynomial",
                     "lr_params": {"power": 1.0, "min_lr": 1e-6}},
           "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [1],
                           "num_res_blocks": 1, "num_head_channels": 4},
           "feature_cond_encoder": {"type": "selfattn", "embed_dim": 16, "n_heads": 2, "d_head": 8,
                                    "model_depth": 1},
           "dataset": {"kind": "synthetic", "volume_shape": [8, 8, 8], "num_cases": 3, "context_len": 6}}
    cfg.update(kw)
    return cfg


def test_cli_trains_text_refiner_and_resumes(tmp_path, capsys):
    """train_mask with selfattn: AdamW and the EMA over the UNet's and the
    refiner's parameters (the refiner's dropout 0.2 on), the context of
    (context_len, embed_dim) per case, validation with each case's context,
    checkpoints that carry the refiner, and a resume."""
    cfg = _cli_cfg(tmp_path / "runs")
    state = tcli.run(cfg, "e1")
    logdir = tmp_path / "runs" / "e1"
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(r["train/grad_finite"] == 1.0 and np.isfinite(r["train/loss"]) for r in train)
    assert [r["step"] for r in recs if "val/dice" in r] == [4]
    refiner = [n for n in state.names if n.startswith("refiner.")]
    assert len(refiner) == 20 and "refiner.block_0.ff.GEGLU_0.Dense_0.weight" in refiner
    fresh = dict(TMask.create(cond_channels=1, num_classes=4, time_steps=20, model_channels=8,
                              channel_mult=(1, 2), attention_resolutions=(1,), num_res_blocks=1,
                              num_head_channels=4, device="cpu", context_dim=16,
                              text_refiner=cfg["feature_cond_encoder"]).named_parameters())
    params = dict(zip(state.names, state.params))
    assert all(not torch.equal(params[n], fresh[n]) for n in refiner)  # every refiner leaf trained
    ema = dict(zip(state.names, state.ema))
    assert all(not torch.equal(ema[n], params[n]) for n in refiner)
    ck = CheckpointManager(logdir / "checkpoints")
    assert ck.all_steps()["rolling"] == [2, 4]
    saved = ck.restore(4)
    assert set(refiner) <= set(saved["params"]) and set(refiner) <= set(saved["ema"])
    capsys.readouterr()
    state2 = tcli.run({**cfg, "load_from": True, "max_steps": 6}, "e1")
    assert "resumed from step 4" in capsys.readouterr().out and state2.step == 6
    assert CheckpointManager(logdir / "checkpoints").restore(6)["params"].keys() == saved["params"].keys()


def test_cli_dataset_context_and_rejects(tmp_path):
    from jointimagegeneration_torch.cli.common import build_mask_dataset
    from jointimagegeneration_tpu.cli.common import build_mask_dataset as jax_build

    cfg = _cli_cfg(tmp_path)
    for c in (cfg, {**cfg, "dataset": {"kind": "synthetic", "volume_shape": [8, 8, 8], "num_cases": 3}}):
        got, want = build_mask_dataset(c, "train")[1], jax_build(c, "train")[1]
        assert got.keys() == want.keys()
        for k in ("mask", "image", "context"):
            np.testing.assert_array_equal(got[k], want[k])
    assert build_mask_dataset(cfg)[0]["context"].shape == (6, 16)
    assert "context" not in build_mask_dataset({**cfg, "feature_cond_encoder": {"type": "none"}})[0]
    with pytest.raises(ValueError, match="2D"):  # dino features are 2D; this stage 1 is 3D
        tcli.run(_cli_cfg(tmp_path, feature_cond_encoder={"type": "dino"}), "bad")


# a long report: one 512-token BERT chunk and a 128-token one (640 tokens), so
# the refiner's self-attention, and the UNet's cross-attention over it, take
# the flash rule on both sides
LONG_CTX = (640, 128)
LONG_REFINER = {"type": "selfattn", "embed_dim": 128, "n_heads": 2, "d_head": 64, "model_depth": 2, "dropout": 0.0}


def test_long_report_step_through_flash_matches_jax(monkeypatch):
    """The fp32 text step's loss and every gradient over a 640-token context:
    the JAX step with its flash dispatch switched on (the Pallas forward and
    backward kernels in interpret mode on the CPU, at every site of >= 512
    query tokens: the UNet's self- and cross-attention and the refiner's 2 x 2
    sites of 2 heads x 64) against the port's step, whose flash sites take
    the kernels' plain versions on the CPU.  Within 1e-5 of each tensor's
    max (the two sum the same products in another order)."""
    import jointimagegeneration_tpu.ops.attention as jattn
    import jointimagegeneration_tpu.ops.pallas.flash_attention as jflash
    from jointimagegeneration_torch.ops import attention as tattn

    jm = MaskSampler.create(context_dim=LONG_CTX[1], text_refiner=LONG_REFINER, **UNET)
    rs = np.random.RandomState(17)
    ctx = rs.randn(1, *LONG_CTX).astype(np.float32)
    pu = init_flax(jm.unet, jnp.zeros((*SHAPE, 4)), jnp.zeros((1,)), cond=jnp.zeros((*SHAPE, 1)),
                   context=jnp.asarray(ctx))
    pr = init_flax(jm.refiner, jnp.asarray(ctx), seed=5)
    tree = {"unet": {"params": pu}, "refiner": {"params": pr}}
    item = SyntheticMaskDataset(num_cases=1, volume_shape=SHAPE[1:], num_classes=4)[0]
    batch = {"mask": item["mask"][None], "image": rs.rand(*SHAPE, 1).astype(np.float32), "context": ctx}
    cw = jnp.asarray([0.5, 1.0, 2.0, 1.5])
    key = jax.random.key(21)
    x0, cond, jctx = (jnp.asarray(batch[k]) for k in ("mask", "image", "context"))

    jax_sites, real_jflash = [], jflash.flash_attention

    def recording_jflash(q, k, v, **kw):
        jax_sites.append((q.shape[2], k.shape[2], q.shape[3]))
        return real_jflash(q, k, v, **kw)

    monkeypatch.setattr(jattn, "_flash_available", lambda: True)
    monkeypatch.setattr(jflash, "flash_attention", recording_jflash)

    def loss_fn(params):
        diff = jm.diffusion
        kt, kx, kd = jax.random.split(key, 3)
        t = jlosses.sample_train_timesteps(kt, 1, diff.time_steps)
        xt = diff.sample_q_xt_given_x0(kx, x0, t)
        context = jm.refine_context(params, jctx, rng=kd)
        x0pred = jm.unet.apply(unet_vars(params), xt, t.astype(jnp.float32), cond=cond, context=context)
        return jlosses.categorical_diffusion_loss(diff.theta_post(xt, x0, t), diff.theta_post_prob(xt, x0pred, t),
                                                  x0, x0pred, cw)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    # the refiner's 4 sites at 640 tokens and the UNet's cross-attention over them went through the kernels
    assert jax_sites.count((640, 640, 64)) == 4 and (512, 640, 16) in jax_sites
    want = unet_state_dict_from_jax(jax.device_get(jgrads))

    port_sites, real_tflash = [], tattn.flash_attention

    def recording_tflash(q, k, v):
        port_sites.append((q.shape[2], k.shape[2], q.shape[3]))
        return real_tflash(q, k, v)

    monkeypatch.setattr(tattn, "flash_attention", recording_tflash)
    tm = TMask.create(cond_channels=1, dtype=torch.float32, device="cpu", context_dim=LONG_CTX[1],
                      text_refiner=LONG_REFINER, **UNET)
    state = unet_state_dict_from_jax(tree)
    named = dict(tm.named_parameters())
    assert sorted(state) == sorted(named)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(state[n])
    noise = ReplayNoise(_draws(key, x0.shape))
    loss, _ = mask_loss(tm, noise, {k: to_torch(v) for k, v in batch.items()}, to_torch(np.asarray(cw)))
    names = list(named)
    grads = dict(zip(names, torch.autograd.grad(loss, [named[n] for n in names])))
    assert sorted(set(port_sites)) == sorted(set(jax_sites)) and port_sites.count((640, 640, 64)) == 4
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(want) == sorted(grads)
    for n, g in grads.items():
        _scaled(to_numpy(g), want[n].numpy(), 1e-5, n)
    assert np.abs(to_numpy(grads["refiner.block_1.attn1.to_q.weight"])).max() > 0
