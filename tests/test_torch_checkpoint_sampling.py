"""PyTorch port: the sampler reads what the port's trainers write, on the CPU.

A tiny stage 1 (with and without the text refiner) and a tiny stage 2 (with
and without `learn_logvar`) train for 2 steps through their CLIs; `stage:
mask` / `stage: ct` then sample from the run's `checkpoints/` directory (its
newest step), from one rolling `.pt` file and from a `trainstep/` weights
snapshot.  Each result equals, bit for bit, sampling with the same draws
from that file's EMA weights loaded by hand.  A JAX stage-2 tree with a
learned `logvar` loads from a '/'-joined `.npz` and as a tuple-keyed tree;
the AE sections read a port `.pt`; anything else raises ValueError naming
the forms accepted.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import sample as tcli
from jointimagegeneration_torch.cli import train_ldm, train_mask
from jointimagegeneration_torch.cli.common import build_autoencoder, build_latent_ldm, load_ae_weights
from jointimagegeneration_torch.diffusion.ddim import DDIMParams
from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.utils.jax_weights import flat_paths, flatten_tree, unet_state_dict_from_jax
from jointimagegeneration_tpu.models.slice_ldm import SliceLDM

from test_torch_weights import init_flax

UNET1 = {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2], "num_res_blocks": 1,
         "num_head_channels": 4}
UNET2 = {"model_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2], "num_res_blocks": 1,
         "num_head_channels": 4}
FCE = {"type": "selfattn", "embed_dim": 16, "n_heads": 2, "d_head": 8, "model_depth": 1}
SOURCES = ["directory", "rolling_pt", "trainstep_pt"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checkpoint(logdir, source: str) -> str:
    ck = logdir / "checkpoints"
    return str({"directory": ck, "rolling_pt": ck / "1.pt", "trainstep_pt": ck / "trainstep" / "2.pt"}[source])


def _ema(path: str) -> dict:
    """The EMA weights a checkpoint source names, read by hand."""
    if not path.endswith(".pt"):
        path = f"{path}/2.pt"  # the newest rolling step
    return torch.load(path, map_location="cpu", weights_only=True)["ema"]


@pytest.fixture(scope="module")
def stage1_runs(tmp_path_factory):
    """{refiner?: (logdir, training config)} after 2 steps on synthetic masks."""
    out = {}
    for text in (False, True):
        root = tmp_path_factory.mktemp(f"s1_{text}")
        cfg = {"output_path": str(root), "seed": 0, "num_classes": 4, "time_steps": 20, "bf16": False,
               "batch_size": 1, "max_steps": 2, "save_freq": 1, "save_weights_every": 2, "display_freq": 1,
               "validate": False, "device": "cpu", "optim": {"name": "AdamW", "learning_rate": 1e-2},
               "unet_openai": UNET1,
               "dataset": {"kind": "synthetic", "volume_shape": [4, 8, 8], "num_cases": 3, "context_len": 5}}
        if text:
            cfg["feature_cond_encoder"] = FCE
        train_mask.run(cfg, "e")
        np.savez(root / "feat.npz", features=np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32))
        out[text] = (root / "e", cfg)
    return out


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("text", [False, True], ids=["unet", "unet+refiner"])
def test_mask_sampling_from_a_trainer_checkpoint(tmp_path, stage1_runs, capsys, text, source):
    logdir, train_cfg = stage1_runs[text]
    s1 = {k: v for k, v in train_cfg.items() if k not in ("output_path", "device")}
    ckpt = _checkpoint(logdir, source)
    cfg = {"stage": "mask", "device": "cpu", "seed": 7, "n_cases": 1, "mask_steps": 3, "output_path": str(tmp_path),
           "stage1": {**s1, "checkpoint": ckpt}}
    if text:
        cfg["text"] = {"features_npz": str(logdir.parent / "feat.npz")}
    out = tcli.run(cfg)
    assert "FRESH-INIT" not in capsys.readouterr().out
    ema = _ema(ckpt)
    assert any(k.startswith("refiner.") for k in ema) == text
    ms = tcli.build_mask_sampler(s1, "cpu")
    ms.unet.load_state_dict({k: v for k, v in ema.items() if not k.startswith("refiner.")})
    if text:
        ms.refiner.load_state_dict({k[len("refiner."):]: v for k, v in ema.items() if k.startswith("refiner.")})
    item = tcli.build_mask_dataset(s1, "val")[0]
    ctx = tcli.load_text_context(cfg.get("text"), "cpu")
    with torch.inference_mode():
        want = ms.sample_labels(NoiseSource(7, "cpu"), (1, 4, 8, 8), cond=torch.from_numpy(item["image"])[None],
                                context=ctx, num_steps=3)
    np.testing.assert_array_equal(out["labels"][:, 0], want.numpy())


@pytest.fixture(scope="module")
def stage2_runs(tmp_path_factory):
    """{learn_logvar: (logdir, training config)} after 2 steps on synthetic slices."""
    out = {}
    for logvar in (False, True):
        root = tmp_path_factory.mktemp(f"s2_{logvar}")
        cfg = {"output_path": str(root), "seed": 0, "batch_size": 1, "max_steps": 2, "save_freq": 1,
               "save_weights_every": 2, "display_freq": 1, "validate": False, "device": "cpu",
               "model": {"timesteps": 20, "bf16": False, "learn_logvar": logvar, "base_learning_rate": 1e-3,
                         "unet_config": {"params": UNET2}},
               "dataset": {"kind": "synthetic", "slice_shape": [16, 16], "depth": 3, "num_cases": 3}}
        train_ldm.run(cfg, "e")
        out[logvar] = (root / "e", cfg)
    return out


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("logvar", [False, True], ids=["unet", "unet+logvar"])
def test_ct_sampling_from_a_trainer_checkpoint(tmp_path, stage2_runs, logvar, source):
    logdir, train_cfg = stage2_runs[logvar]
    s2 = {**train_cfg["model"], "dataset": train_cfg["dataset"], "slice_size": 16}
    ckpt = _checkpoint(logdir, source)
    cfg = {"stage": "ct", "device": "cpu", "seed": 5, "n_cases": 1, "ddim_steps": 3, "metrics": False,
           "output_path": str(tmp_path), "stage2": {**s2, "checkpoint": ckpt}}
    out = tcli.run(cfg)
    ema = _ema(ckpt)
    assert ("logvar" in ema) == logvar
    ldm = tcli.build_slice_ldm(s2, "cpu")
    ldm.unet.load_state_dict({k: v for k, v in ema.items() if k != "logvar"})
    item = tcli.build_slice_dataset(s2, "val")[0]
    with torch.inference_mode():
        want = ldm.sample_volume(NoiseSource(5, "cpu"), torch.from_numpy(item["wholemask"])[None],
                                 DDIMParams.create(ldm.diffusion, 3))
    np.testing.assert_array_equal(out["ct"][0], want[0, ..., 0].numpy())


def _jax_stage2_tree():
    """A JAX SliceLDM tree with a learned logvar: {"unet": {"params": ...},
    "logvar": (T,)}, as `SliceLDM.init_params(learn_logvar=True)` nests it."""
    js = SliceLDM.create(timesteps=20, model_channels=8, channel_mult=(1, 2), attention_resolutions=(2,),
                         num_res_blocks=1, num_head_channels=4)
    params = init_flax(js.unet, jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,)), cond=jnp.zeros((1, 16, 16, 2)))
    return params, {"unet": {"params": params}, "logvar": np.linspace(-1, 1, 20).astype(np.float32)}


def test_jax_tree_with_logvar_loads_both_ways(tmp_path):
    """The '/'-joined `.npz` splits key by key (`logvar` holds no '/'), a
    tuple-keyed tree gives the same state, and the sampler drops `logvar`."""
    params, tree = _jax_stage2_tree()
    flat = flatten_tree(tree)
    path = tmp_path / "ema.npz"
    np.savez(path, **{"/".join(k): v for k, v in flat.items()})
    assert set(flat_paths(str(path))) == set(flat) and ("logvar",) in flat
    from_npz, from_tuples = unet_state_dict_from_jax(str(path)), unet_state_dict_from_jax(flat)
    want = unet_state_dict_from_jax(params)
    assert from_npz.keys() == from_tuples.keys() == set(want) | {"logvar"}
    for k, v in want.items():
        assert torch.equal(from_npz[k], v) and torch.equal(from_tuples[k], v), k
    ldm = tcli.build_slice_ldm({"timesteps": 20, "bf16": False, "unet_config": {"params": UNET2}}, "cpu")
    tcli.load_weights(ldm.unet, str(path), 0.0, 0)
    for k, v in ldm.unet.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_checkpoint_forms_and_ae_weights(tmp_path, stage2_runs):
    """A port `.pt` with the AE's EMA weights loads into the AE section, and
    `latent_scale.json` is read inside a checkpoint directory; an empty
    directory, another file and a `.pt` without EMA weights raise
    ValueError naming the forms accepted."""
    ae_cfg = {"embed_dim": 4, "ddconfig": {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [],
                                           "resolution": 16}}
    src = build_autoencoder(ae_cfg, "cpu", seed=11)
    torch.save({"ema": src.state_dict(), "step": 3}, tmp_path / "ae.pt")
    dst = build_autoencoder(ae_cfg, "cpu")
    load_ae_weights(dst, {"checkpoint": str(tmp_path / "ae.pt")})
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    logdir, train_cfg = stage2_runs[False]
    (logdir / "checkpoints" / "latent_scale.json").write_text(json.dumps({"scale_factor": 0.3}))
    s2 = {**train_cfg["model"], "checkpoint": str(logdir / "checkpoints"),
          "first_stage": {**ae_cfg, "checkpoint": str(tmp_path / "ae.pt")},
          "cond_stage": {"embed_dim": 4, "ddconfig": {**ae_cfg["ddconfig"], "in_channels": 2, "out_ch": 2}}}
    latent, _ = build_latent_ldm(s2, tcli.build_slice_ldm(train_cfg["model"], "cpu"), 16, "cpu")
    assert latent.scale_factor == pytest.approx(0.3)
    (tmp_path / "empty").mkdir()
    (tmp_path / "w.txt").write_text("x")
    torch.save({"params": src.state_dict()}, tmp_path / "no_ema.pt")
    unet = tcli.build_slice_ldm(train_cfg["model"], "cpu").unet
    for bad in ("empty", "w.txt", "no_ema.pt", "missing.npz"):
        with pytest.raises(ValueError, match="directory of <step>.pt files"):
            tcli.load_weights(unet, str(tmp_path / bad), 0.0, 0)
    with pytest.raises(ValueError, match="lacks|holds leaves"):  # a stage-2 checkpoint into the AE
        load_ae_weights(dst, {"checkpoint": str(logdir / "checkpoints")})
