"""PyTorch port: DINO feature-conditioned stage 1 against the JAX package on the CPU.

The UNet with `feature_cond` at the stem (site 0), at a ResBlock (1), at a
down-transition (2: its conv, the skip it pushes, the next level's first
ResBlock and the decoder ResBlock that pops the skip all widen) and at two
sites at once, in fp32 (within 1e-5 of the output's max) and bf16 (3e-2, as
tests/test_torch_unet.py); `sample_labels` with features under replayed
draws (equal labels); the train step's loss and gradients with features
(fp32, 1e-5 of each tensor's max; base 64, so no GroupNorm group holds one
channel); `configs/stage1_mask_dino.yml` through `cli.train_mask` and then
`cli.sample` `stage: mask` from its checkpoint, at tiny widths with the full
ViT-S/8 (the extractor from `seed` + 11 on both surfaces); a translated
reference dino config; `dims: 3` raising, as in the JAX package."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import sample as tsample
from jointimagegeneration_torch.cli import train_mask as ttrain
from jointimagegeneration_torch.cli.common import build_dino_feature_fn, fill_zero_init, read_port_checkpoint
from jointimagegeneration_torch.core import ref_import as tref
from jointimagegeneration_torch.core.config import apply_overrides, load_yaml_config
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.models.mask_sampler import MaskSampler as TMask
from jointimagegeneration_torch.nn.unet import UNet as TUNet
from jointimagegeneration_torch.pipeline.two_stage import make_chunked_two_stage_programs
from jointimagegeneration_torch.train.steps import mask_loss
from jointimagegeneration_torch.utils.jax_weights import unet_state_dict_from_jax
from jointimagegeneration_tpu.cli import common as jcommon
from jointimagegeneration_tpu.models.mask_sampler import MaskSampler
from jointimagegeneration_tpu.nn.unet import UNet
from jointimagegeneration_tpu.train import losses as jlosses

from test_ref_import import _ccdm_params
from test_torch_train import _step_draws
from test_torch_weights import ReplayNoise, assert_close_scaled, init_flax, jax_apply, jax_mask_draws, load_port, \
    to_numpy, to_torch

ROOT = Path(__file__).resolve().parents[1]
F_WIDTH = 6
SMALL = dict(model_channels=8, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2), dims=2,
             num_head_channels=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(sites, spatial, b=2, seed=5):
    """{site: (B, *spatial at the site, F)} features, seeded."""
    rs = np.random.RandomState(seed)
    return {i: rs.randn(b, *(s // (1 if i < 3 else 2) for s in spatial), F_WIDTH).astype(np.float32)
            for i in sites}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("sites", [(0,), (1,), (2,), (1, 3)], ids=["stem", "resblock", "downsample", "two"])
def test_unet_feature_cond_matches_jax(sites, dt):
    jdt, tdt = (jnp.float32, torch.float32) if dt == "fp32" else (jnp.bfloat16, torch.bfloat16)
    spatial = (16, 16)
    rs = np.random.RandomState(0)
    x = rs.randn(2, *spatial, 4).astype(np.float32)
    cond = rs.rand(2, *spatial, 1).astype(np.float32)
    t = np.array([3.0, 17.0], np.float32)
    fc = _features(sites, spatial)
    net = UNet(out_channels=4, softmax_output=True, dtype=jdt, **SMALL)
    p = init_flax(net, jnp.asarray(x[:1]), jnp.asarray(t[:1]), cond=jnp.asarray(cond[:1]),
                  feature_cond={i: jnp.asarray(v[:1]) for i, v in fc.items()})
    want = np.asarray(jax_apply(net, p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                                feature_cond={i: jnp.asarray(v) for i, v in fc.items()}))
    port = load_port(TUNet(in_channels=5, out_channels=4, softmax_output=True, dtype=tdt, device="cpu",
                           feature_cond_channels={i: F_WIDTH for i in sites}, **SMALL), p)
    with torch.no_grad():
        got = to_numpy(port(to_torch(x), to_torch(t), cond=to_torch(cond),
                            feature_cond={i: to_torch(v) for i, v in fc.items()}))
    assert got.shape == want.shape == (2, *spatial, 4)
    assert_close_scaled(got, want, 1e-5 if dt == "fp32" else 3e-2)
    if 2 in sites:  # the widened skip of the down-transition reaches the decoder
        assert port.down_0_ds.op.weight.shape[:2] == (8 + F_WIDTH, 8 + F_WIDTH)
        assert port.down_1_0_res.conv1_kernel.shape[1] == 8 + F_WIDTH
        assert port.up_1_1_res.conv1_kernel.shape[1] == 16 + 8 + F_WIDTH  # pops the down-transition's skip


def test_unet_feature_sites_are_checked():
    with pytest.raises(ValueError, match="beyond the encoder"):
        TUNet(in_channels=5, out_channels=4, device="cpu", feature_cond_channels={5: 3}, **SMALL)
    net = TUNet(in_channels=5, out_channels=4, device="cpu", feature_cond_channels={1: 3}, **SMALL)
    with pytest.raises(ValueError, match="feature_cond sites"):
        net(torch.zeros(1, 8, 8, 5), torch.zeros(1))


MASK = dict(num_classes=4, time_steps=20, **SMALL)


def test_sample_labels_with_features_replayed():
    jm = MaskSampler.create(**MASK)
    shape = (2, 16, 16)
    fc = _features((2,), shape[1:])
    p = init_flax(jm.unet, jnp.zeros((1, *shape[1:], 4)), jnp.zeros((1,)), cond=jnp.zeros((1, *shape[1:], 1)),
                  feature_cond={2: jnp.asarray(fc[2][:1])})
    cond = np.random.RandomState(2).rand(*shape, 1).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jm.sample_labels({"params": p}, key, shape, cond=jnp.asarray(cond), num_steps=4,
                                       feature_cond={2: jnp.asarray(fc[2])}))
    tm = TMask.create(cond_channels=1, device="cpu", feature_cond_channels={2: F_WIDTH}, **MASK)
    load_port(tm.unet, p)
    noise = ReplayNoise(jax_mask_draws(key, shape, 4, 4))
    got = tm.sample_labels(noise, shape, cond=to_torch(cond), num_steps=4,
                           feature_cond={2: to_torch(fc[2])}).numpy()
    assert not noise.draws and len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_chunked_programs_pass_features_to_stage_1():
    """The two-stage mask program hands `feature_cond` to the sampler: its
    labels equal `sample_labels` with the same features and draws (3D: the
    UNet's sites take features in any rank)."""
    kw = {**MASK, "dims": 3}
    tm = TMask.create(cond_channels=1, device="cpu", feature_cond_channels={1: 3}, seed=3, **kw)
    fill_zero_init(tm.unet, 0.3, 1)  # a fresh UNet's zero head would ignore its input
    shape, fc = (1, 4, 8, 8), {1: torch.randn(1, 4, 8, 8, 3, generator=torch.Generator().manual_seed(0))}
    cond = torch.zeros((*shape, 1))
    mask_program, _ = make_chunked_two_stage_programs(tm, None, mask_shape=shape, volume_shape=(4, 8, 8),
                                                      ddim=None, chunk=4, mask_steps=3, cond=cond, feature_cond=fc)
    labels, _ = mask_program(NoiseSource(7, "cpu"))
    want = tm.sample_labels(NoiseSource(7, "cpu"), shape, cond=cond, num_steps=3, feature_cond=fc)
    assert torch.equal(labels, want) and len(torch.unique(want)) > 1
    other = tm.sample_labels(NoiseSource(7, "cpu"), shape, cond=cond, num_steps=3, feature_cond={1: fc[1] * 0})
    assert not torch.equal(other, want)


STEP = dict(num_classes=4, time_steps=20, model_channels=64, channel_mult=(1, 1), attention_resolutions=(2,),
            num_res_blocks=1, num_head_channels=16, dims=2)


@pytest.mark.parametrize("site", [1, 2])
def test_train_step_with_features_matches_jax(site):
    """The JAX step's loss_fn (steps.py:44-59) with `feature_cond` at the
    site, against `mask_loss` with `feature_inject_idx`; the draws t, x_t
    replayed in that order."""
    spatial = (8, 8)
    jm = MaskSampler.create(**STEP)
    rs = np.random.RandomState(site)
    x0 = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (1, *spatial))]
    cond = rs.rand(1, *spatial, 1).astype(np.float32)
    feat = _features((site,), spatial, b=1)[site]
    p = init_flax(jm.unet, jnp.zeros((1, *spatial, 4)), jnp.zeros((1,)), cond=jnp.zeros((1, *spatial, 1)),
                  feature_cond={site: jnp.asarray(feat)})
    key, cw = jax.random.key(13), jnp.asarray([0.5, 1.0, 2.0, 1.5])
    diff = jm.diffusion

    def loss_fn(params):
        kt, kx, _ = jax.random.split(key, 3)
        t = jlosses.sample_train_timesteps(kt, 1, diff.time_steps)
        xt = diff.sample_q_xt_given_x0(kx, jnp.asarray(x0), t)
        x0pred = jm.unet.apply(params, xt, t.astype(jnp.float32), cond=jnp.asarray(cond),
                               feature_cond={site: jnp.asarray(feat)})
        return jlosses.categorical_diffusion_loss(diff.theta_post(xt, jnp.asarray(x0), t),
                                                  diff.theta_post_prob(xt, x0pred, t), jnp.asarray(x0), x0pred, cw)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))({"params": p})
    tm = TMask.create(cond_channels=1, device="cpu", feature_cond_channels={site: F_WIDTH}, **STEP)
    load_port(tm.unet, p)
    noise = ReplayNoise(_step_draws(key, 1, 20, x0.shape))
    batch = {"mask": to_torch(x0), "image": to_torch(cond), "feature_cond": to_torch(feat)}
    loss, _ = mask_loss(tm, noise, batch, to_torch(np.asarray(cw)), feature_inject_idx=site)
    assert not noise.draws
    named = list(tm.unet.named_parameters())
    grads = dict(zip([n for n, _ in named], torch.autograd.grad(loss, [q for _, q in named])))
    want = unet_state_dict_from_jax(jax.device_get(jgrads))
    assert sorted(want) == sorted(grads)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for n, g in grads.items():
        assert_close_scaled(to_numpy(g), want[n].numpy(), 1e-5)


def _dino_cfg(out: Path):
    """configs/stage1_mask_dino.yml at tiny widths (the full ViT-S/8 at 32x32)."""
    return load_yaml_config(ROOT / "configs" / "stage1_mask_dino.yml", overrides=[
        f"output_path={out}", "device=cpu", "bf16=false", "time_steps=20", "batch_size=2", "max_steps=2",
        "save_freq=2", "display_freq=1", "validation_freq_steps=2", "eval_time_steps=2", "n_validation_images=1",
        "mp_loaders=1", "unet_openai.base_channels=8", "unet_openai.channel_mult=[1,2]",
        "unet_openai.attention_resolutions=[2]", "unet_openai.num_head_channels=4", "unet_openai.num_res_blocks=1",
        "dataset.volume_shape=[32,32]", "dataset.num_cases=3"])


def test_dino_config_trains_then_samples(tmp_path, capsys):
    cfg = _dino_cfg(tmp_path / "runs")
    assert cfg["feature_cond_encoder"]["type"] == "dino" and cfg["dims"] == 2
    state = ttrain.run(cfg, "e1")
    assert state.step == 2 and not any("vit" in n or "block_" in n for n in state.names)  # frozen, not in the state
    logdir = tmp_path / "runs" / "e1"
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2] and all(r["train/grad_finite"] == 1.0 for r in train)
    assert [r["step"] for r in recs if "val/dice" in r] == [2]
    # the UNet is widened by the ViT-S width at inject_idx 1
    assert dict(zip(state.names, state.params))["down_0_0_res.conv1_kernel"].shape[1] == 8 + 384
    sample_cfg = {"stage": "mask", "seed": 4, "n_cases": 2, "batch_size": 2, "mask_steps": 3, "device": "cpu",
                  "output_path": str(tmp_path / "samples"),
                  "stage1": {**cfg, "checkpoint": str(logdir / "checkpoints")}}
    capsys.readouterr()
    out = tsample.run(sample_cfg)
    assert "FRESH-INIT" not in capsys.readouterr().out
    assert out["labels"].shape == (2, 1, 32, 32) and (tmp_path / "samples" / "case_0001" / "pred.nii.gz").exists()
    # by hand: the checkpoint's EMA weights, the extractor from the training config's seed + 11
    ms = tsample.build_mask_sampler(cfg, "cpu")
    ms.unet.load_state_dict(read_port_checkpoint(str(logdir / "checkpoints")))
    feat_fn, idx, site = build_dino_feature_fn(cfg, (32, 32), "cpu")
    assert (idx, site) == (1, (32, 32, 384))
    ds = ttrain.build_mask_dataset(cfg, "val")
    cond = torch.from_numpy(np.stack([ds[i]["image"] for i in range(2)]))
    with torch.no_grad():
        want = ms.sample_labels(NoiseSource(4, "cpu"), (2, 32, 32), cond=cond, feature_cond={1: feat_fn(cond)},
                                num_steps=3)
    np.testing.assert_array_equal(out["labels"][:, 0], want.numpy())
    other_fn, _, _ = build_dino_feature_fn(cfg, (32, 32), "cpu", seed=cfg["seed"] + 12)
    assert not torch.equal(other_fn(cond + 1), feat_fn(cond + 1))  # another seed, another extractor


def test_translated_reference_dino_config_trains(tmp_path):
    """A reference params.yml with a dino encoder, through the port's
    importer, drives the port's trainer (tiny widths)."""
    ref = _ccdm_params(dims=2, feature_cond_encoder={"type": "dino", "source_layer": 11})
    cfg, _ = tref.import_reference_config(ref)
    assert cfg["feature_cond_encoder"] == {"type": "dino", "layer": 11}
    apply_overrides(cfg, [f"output_path={tmp_path}", "remat=false", "bf16=false", "max_steps=1", "save_freq=1",
                          "display_freq=1", "validate=false", "mp_loaders=1", "time_steps=20", "batch_size=1",
                          "unet_openai.base_channels=8", "unet_openai.channel_mult=[1,2]",
                          "unet_openai.attention_resolutions=[2]", "unet_openai.num_head_channels=4",
                          "dataset={kind: synthetic, volume_shape: [16, 16], num_cases: 2}"])
    state = ttrain.run(cfg, "e1", device="cpu")
    assert state.step == 1
    assert dict(zip(state.names, state.params))["down_0_0_res.conv1_kernel"].shape[1] == 8 + 384


def test_dims_3_raises_as_in_jax():
    cfg = {"dims": 3, "feature_cond_encoder": {"type": "dino"}}
    with pytest.raises(ValueError, match="2D"):
        build_dino_feature_fn(cfg, (8, 16, 16), "cpu")
    with pytest.raises(ValueError, match="2D"):
        jcommon.build_dino_feature_fn(cfg, (8, 16, 16))
    assert build_dino_feature_fn({"dims": 3}, (8, 16, 16), "cpu") == (None, None, None)
