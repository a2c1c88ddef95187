"""PyTorch port: the first-stage AE trainer (the PatchGAN discriminator, the
GAN losses, the KL and VQ train steps, `cli.train_ae`) held against the JAX
package on the CPU.

The JAX steps run from the same parameters (`init_flax`: every leaf carries
signal) and the port replays their posterior draw (`ReplayNoise`).
Tolerances:
  * the discriminator, its features and the d-losses: within 1e-5 of each
    output's max |.| (fp32 convs summing in another order);
  * the steps' losses and d_weight: rtol 1e-5;
  * the gradients of a step (Adam's first moment after it, (1 - b1) x g in
    both frameworks): within 1e-5 of each tensor's max |gradient|;
  * the parameters after the step: rtol 1e-5 plus 2e-3 of the lr absolute
    (Adam's bias corrections, optax's in float32, torch's in float64, make one
    update differ by ~6e-6 of itself; test_torch_train.py), on every element
    whose gradient is above 1e-4 of its tensor's max.  A first Adam update is
    lr x the sign of the gradient, and an element whose gradient is within
    the frameworks' summation noise of zero (1e-5 of the max, measured: one
    of 36,864 kernel elements in a step) takes either sign.
    The AE is 64 wide for the same reason (GroupNorm groups of 2 and 4
    channels): at one channel a group the bias before a norm has a zero
    gradient in exact arithmetic, as softmax gives the attention's key bias.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import train_ae as tcli
from jointimagegeneration_torch.cli.common import build_autoencoder, load_ae_weights
from jointimagegeneration_torch.models.autoencoder import AutoencoderKL as TKL
from jointimagegeneration_torch.models.autoencoder import VQModel as TVQ
from jointimagegeneration_torch.nn.discriminators import PatchDiscriminator as TDisc
from jointimagegeneration_torch.train import gan as tgan
from jointimagegeneration_torch.utils.jax_weights import _find_states, ae_state_dict_from_jax
from jointimagegeneration_tpu.models.autoencoder import AutoencoderKL, VQModel
from jointimagegeneration_tpu.nn.discriminators import PatchDiscriminator
from jointimagegeneration_tpu.train import gan as jgan
from jointimagegeneration_tpu.train.optim import build_optimizer

from test_torch_weights import ReplayNoise, assert_close_scaled, init_flax, jax_apply, to_numpy, to_torch

TOL = 1e-5
LR = 1e-3
AE = dict(embed_dim=3, ch=64, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), z_channels=3,
          in_channels=1, out_ch=1, resolution=16)
DISC = dict(dims=2, ndf=64, n_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# ----------------------------------------------------- the discriminator --

@pytest.mark.parametrize("dims,n_layers,shape", [(2, 2, (2, 16, 20, 2)), (2, 3, (1, 32, 32, 1)),
                                                 (3, 2, (1, 16, 16, 16, 1))])
def test_discriminator_and_features_match_jax(dims, n_layers, shape):
    jm = PatchDiscriminator(dims=dims, ndf=16, n_layers=n_layers)
    x = _x(0, *shape) * 2 - 1
    p = init_flax(jm, jnp.zeros(shape))
    logits, feats = jax_apply(jm, p, jnp.asarray(x), return_features=True)
    tm = TDisc(shape[-1], dims=dims, ndf=16, n_layers=n_layers, device="cpu")
    tm.load_state_dict(ae_state_dict_from_jax(p))
    with torch.no_grad():
        got, got_feats = tm(to_torch(x), return_features=True)
        assert torch.equal(tm(to_torch(x)), got)
    assert got.shape == logits.shape and len(got_feats) == len(feats) == n_layers + 1
    assert_close_scaled(to_numpy(got), np.asarray(logits), TOL)
    for a, b in zip(got_feats, feats):
        assert a.shape == b.shape
        assert_close_scaled(to_numpy(a), np.asarray(b), TOL)


def test_discriminator_init_and_minimum_size():
    """The names follow the flax tree; norm scales one, biases zero; too small
    an input raises as the JAX module does."""
    tm = TDisc(1, ndf=8, n_layers=3, device="cpu", seed=4)
    names = [n for n, _ in tm.named_parameters()]
    assert names == ["conv0.weight", "conv0.bias", "conv1.weight", "conv1.bias", "norm1.weight", "norm1.bias",
                     "conv2.weight", "conv2.bias", "norm2.weight", "norm2.bias", "conv3.weight", "conv3.bias",
                     "norm3.weight", "norm3.bias", "head.weight", "head.bias"]
    assert tm.conv3.weight.shape == (64, 32, 4, 4) and tm.head.weight.shape == (1, 64, 4, 4)
    assert all(float(p.detach().abs().max()) == 0 for n, p in tm.named_parameters() if n.endswith("bias"))
    assert all(torch.equal(p, torch.ones_like(p)) for n, p in tm.named_parameters() if n.startswith("norm")
               and n.endswith("weight"))
    with pytest.raises(ValueError, match="needs spatial >= 32"):
        tm(torch.zeros(1, 31, 40, 1))
    jm = PatchDiscriminator(ndf=8, n_layers=3)
    with pytest.raises(ValueError, match="needs spatial >= 32"):
        jax_apply(jm, init_flax(jm, jnp.zeros((1, 32, 32, 1))), jnp.zeros((1, 31, 40, 1)))


@pytest.mark.parametrize("name", ["hinge_d_loss", "vanilla_d_loss"])
def test_d_losses_match_jax(name):
    real, fake = _x(1, 2, 5, 5, 1) * 4 - 2, _x(2, 2, 5, 5, 1) * 4 - 2
    want = float(getattr(jgan, name)(jnp.asarray(real), jnp.asarray(fake)))
    got = float(getattr(tgan, name)(to_torch(real), to_torch(fake)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------------------- the steps --

def _pair(vq: bool):
    """JAX and port AE + discriminator from the same parameters, each in a
    GANTrainState with Adam (0.5, 0.9) at LR."""
    if vq:
        jm, tm = VQModel(n_embed=16, **AE), TVQ(n_embed=16, device="cpu", **AE)
    else:
        jm, tm = AutoencoderKL(**AE), TKL(device="cpu", **AE)
    jd = PatchDiscriminator(**DISC)
    g = init_flax(jm, jnp.zeros((1, 16, 16, 1)), seed=3)
    d = init_flax(jd, jnp.zeros((1, 16, 16, 1)), seed=5)
    tm.load_state_dict(ae_state_dict_from_jax(g))
    td = TDisc(1, device="cpu", **DISC)
    td.load_state_dict(ae_state_dict_from_jax(d))
    tx = lambda: build_optimizer("Adam", LR, betas=(0.5, 0.9))
    jstate = jgan.GANTrainState.create({"params": g}, {"params": d}, tx(), tx())
    return jm, jd, jstate, tm, td, tgan.GANTrainState.create(tm, td, LR)


def _check_step(vq: bool, kw: dict, x: np.ndarray, key, metric_names):
    """One JAX step and one port step (with the JAX posterior draw) from the
    same state: the metrics, the gradients and the parameters after it, as
    the module docstring says.  Returns the port's metrics."""
    jm, jd, jstate, tm, td, tstate = _pair(vq)
    make_j, make_t = ((jgan.make_vq_train_step, tgan.make_vq_train_step) if vq else
                      (jgan.make_autoencoder_train_step, tgan.make_autoencoder_train_step))
    jstate2, jmetrics = jax.jit(make_j(jm, jd, **kw))(jstate, {"image": jnp.asarray(x)}, key)
    draws = []
    if not vq:
        k_sample, _ = jax.random.split(key)
        draws = [("normal", np.asarray(jax.random.normal(k_sample, (x.shape[0], 8, 8, 3), jnp.float32)))]
    noise = ReplayNoise(draws)
    metrics = make_t(tm, td, **kw)(tstate, {"image": to_torch(x)}, noise)
    assert not noise.draws and tstate.step == int(jstate2.step) == 1
    for k in metric_names:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=TOL, atol=1e-7, err_msg=k)
    for module, opt, params, jopt in ((tm, tstate.g_opt, jstate2.g_params, jstate2.g_opt),
                                      (td, tstate.d_opt, jstate2.d_params, jstate2.d_opt)):
        want_p = ae_state_dict_from_jax(jax.device_get(params))
        want_g = ae_state_dict_from_jax(jax.device_get(_find_states(jopt, "mu")[0].mu))
        for n, p in module.named_parameters():
            g, w = to_numpy(opt.torch_opt.state[p]["exp_avg"]), want_g[n].numpy()
            scale = np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale, err_msg=f"gradient {n}")
            keep = np.abs(w) > 1e-4 * scale
            np.testing.assert_allclose(to_numpy(p)[keep], want_p[n].numpy()[keep], rtol=1e-5, atol=2e-3 * LR,
                                       err_msg=n)
    return metrics


@pytest.mark.parametrize("case", ["before_disc_start", "after_disc_start", "feature_matching"])
def test_autoencoder_step_matches_jax(case):
    """One KL step: before disc_start (no adversarial term, d_weight 0, the
    discriminator's update a zero), from disc_start on (the adaptive weight,
    the discriminator's hinge update), and with feature matching (and the
    vanilla d-loss)."""
    kw = dict(kl_weight=1e-3, disc_weight=0.5, disc_start=3 if case == "before_disc_start" else 0,
              feature_matching_weight=0.7 if case == "feature_matching" else 0.0)
    if case == "feature_matching":
        kw["disc_loss"] = "vanilla"
    metrics = _check_step(False, kw, _x(7, 2, 16, 16, 1), jax.random.key(11),
                          ("loss", "d_loss", "nll", "kl", "g_adv", "d_weight"))
    if case == "before_disc_start":
        assert float(metrics["d_weight"]) == float(metrics["d_loss"]) == 0.0
    else:
        assert float(metrics["d_weight"]) > 0 and float(metrics["d_loss"]) > 0


def test_vq_step_matches_jax():
    metrics = _check_step(True, dict(codebook_weight=0.8, disc_weight=0.5, disc_start=0), _x(8, 2, 16, 16, 1),
                          jax.random.key(2), ("loss", "d_loss", "nll", "qloss", "g_adv", "d_weight"))
    assert float(metrics["d_weight"]) > 0


def test_gan_state_round_trip():
    """state_dict / load_state_dict carry both models, both Adam states and
    the step: a restored state takes the same next step."""
    _, _, _, tm, td, tstate = _pair(False)
    step = tgan.make_autoencoder_train_step(tm, td, disc_start=0)
    x = to_torch(_x(9, 2, 16, 16, 1))
    gen = torch.Generator().manual_seed(1)
    draw = lambda: [("normal", torch.randn((2, 8, 8, 3), generator=gen).numpy())]
    step(tstate, {"image": x}, ReplayNoise(draw()))
    buf = io.BytesIO()  # a deep copy through torch.save
    torch.save(tstate.state_dict(), buf)
    nxt = draw()
    step(tstate, {"image": x}, ReplayNoise(nxt))
    after = {n: p.detach().clone() for n, p in tm.named_parameters()}
    _, _, _, tm2, td2, tstate2 = _pair(False)
    buf.seek(0)
    tstate2.load_state_dict(torch.load(buf, weights_only=True))
    assert tstate2.step == 1 and tstate2.g_opt.count == tstate2.d_opt.count == 1
    tgan.make_autoencoder_train_step(tm2, td2, disc_start=0)(tstate2, {"image": x}, ReplayNoise(nxt))
    for n, p in tm2.named_parameters():
        assert torch.equal(p, after[n]), n


# --------------------------------------------------------------- the CLI --

def _cli_cfg(tmp_path, **model):
    dd = {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [8], "z_channels": 4,
          "in_channels": 1, "out_ch": 1, "resolution": 32, "dims": 2}
    return {"output_path": str(tmp_path / "runs"), "seed": 0, "batch_size": 2, "max_steps": 2, "save_freq": 2,
            "display_freq": 1, "num_workers": 1,
            "dataset": {"kind": "synthetic", "slice_shape": [32, 32], "depth": 4, "num_cases": 4},
            "model": {"base_learning_rate": 4.5e-6, "embed_dim": 4, "ddconfig": dd,
                      "lossconfig": {"disc_start": 1, "disc_num_layers": 2, "disc_ndf": 16, "kl_weight": 1e-6},
                      **model}}


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_cli_trains_and_its_checkpoint_loads(tmp_path, kind):
    """Two steps (the second past disc_start), the metrics of both, one
    checkpoint whose generator weights `load_ae_weights` reads into a fresh
    AE of the same section, name by name."""
    extra = {"type": "vq", "n_embed": 16} if kind == "vq" else {}
    cfg = _cli_cfg(tmp_path, **extra)
    state = tcli.run(cfg, "ae", device="cpu")
    assert state.step == 2 and state.g_opt.count == state.d_opt.count == 2
    recs = [json.loads(line) for line in (tmp_path / "runs" / "ae" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["train/d_weight"] == recs[0]["train/d_loss"] == 0.0
    assert recs[1]["train/d_weight"] > 0 and recs[1]["train/d_loss"] > 0
    assert ("train/qloss" if kind == "vq" else "train/kl") in recs[0]
    assert state.g_opt.torch_opt.defaults["lr"] == pytest.approx(4.5e-6 * 2)
    ckdir = tmp_path / "runs" / "ae" / "checkpoints"
    assert sorted(p.name for p in ckdir.glob("*.pt")) == ["2.pt"]
    fresh = build_autoencoder(cfg["model"], "cpu", seed=9)
    load_ae_weights(fresh, {"checkpoint": str(ckdir)})
    want = dict(zip((n for n, _ in state.g_opt.named_params), state.g_params))
    for n, p in fresh.state_dict().items():
        assert torch.equal(p, want[n]), n
    other = build_autoencoder({**cfg["model"], "ddconfig": {**cfg["model"]["ddconfig"], "ch": 16}}, "cpu")
    with pytest.raises(ValueError, match="wrong ddconfig"):
        load_ae_weights(other, {"checkpoint": str(ckdir)})


def test_cli_rejects_a_two_channel_ae_on_one_channel_images(tmp_path):
    """configs/stage_ae.yml's in_channels: 2 on the slice dataset's 1-channel
    `image`: a ValueError naming both numbers and the `cond` pair, before any
    step (the JAX trainer fails inside flax with a shape error)."""
    cfg = _cli_cfg(tmp_path)
    cfg["model"]["ddconfig"].update(in_channels=2, out_ch=2)
    with pytest.raises(ValueError, match=r"in_channels is 2 but the dataset's 'image' has 1 channel.*'cond'"):
        tcli.run(cfg, "bad", device="cpu")
    assert not (tmp_path / "runs" / "bad").exists()
    with pytest.raises(ValueError, match="unsupported checkpoint format"):  # init_from is ported: a bad path
        tcli.run({**_cli_cfg(tmp_path), "init_from": {"path": "x"}}, "init", device="cpu")


def test_cli_main_reads_the_stage_ae_config_with_overrides(tmp_path):
    """`configs/stage_ae.yml` with the `in_channels` override it needs, cut
    to a tiny AE: main() trains one step and saves it."""
    tcli.main(["configs/stage_ae.yml", "e1", f"output_path={tmp_path}", "device=cpu", "max_steps=1", "save_freq=1",
               "display_freq=1", "num_workers=1", "model.ddconfig.in_channels=1", "model.ddconfig.out_ch=1",
               "model.ddconfig.ch=8", "model.ddconfig.ch_mult=[1,2]", "model.ddconfig.attn_resolutions=[]",
               "model.ddconfig.resolution=32", "model.lossconfig.disc_num_layers=2", "model.lossconfig.disc_ndf=8",
               "dataset.slice_shape=[32,32]", "dataset.num_cases=2", "dataset.depth=2"])
    assert (tmp_path / "e1" / "checkpoints" / "1.pt").exists()
