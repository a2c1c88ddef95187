"""PyTorch port: the reference-config importer (`core/ref_import.py`) held
against the JAX package's on the fixtures of tests/test_ref_import.py.

The port's copy gives the JAX importer's tree and warnings exactly, apart
from the convert hint, which names the port's converter
(`python -m jointimagegeneration_torch.cli.convert_reference`) where the JAX
one names its script; `_main` names the port's CLIs.  A translated ccdm
train config and an LDM pixel config then train two steps through the port's
trainers, cut to tiny widths by the overrides a user would give (`remat=false`
among them: the port's trainers reject `remat` until it is ported).
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from jointimagegeneration_torch.core import ref_import as tref
from jointimagegeneration_torch.core.config import apply_overrides
from jointimagegeneration_tpu.core import ref_import as jref

from test_ref_import import _ccdm_params, _ldm_yaml

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ae_ref():
    """tests/test_ref_import.py::test_ae_import's reference AE config."""
    return {
        "model": {"base_learning_rate": 4.5e-6, "target": "ldm.models.autoencoder.AutoencoderKL",
                  "params": {"monitor": "val/rec_loss", "embed_dim": 4, "dims": 2, "image_key": "mask",
                             "ckpt_path": "/mnt/ae/last.ckpt",
                             "lossconfig": {"target": "ldm...LPIPSWithDiscriminator",
                                            "params": {"disc_start": 50001, "kl_weight": 1e-6, "disc_weight": 0.5,
                                                       "disc_in_channels": 1, "gan_feat_weight": 0}},
                             "ddconfig": {"double_z": True, "z_channels": 4, "resolution": 512, "in_channels": 2,
                                          "out_ch": 2, "ch": 160, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
                                          "dropout": 0.0, "dims": 2, "attn_resolutions": [16, 8]}}},
        "data": {"target": "main.DataModuleFromConfig",
                 "params": {"batch_size": 1, "num_workers": 24, "wrap": True,
                            "train": {"target": "ldm.data.ruijin_pimage_and_mask.PretrainDataset",
                                      "params": {"split": "train"}}}},
        "lightning": {"trainer": {"benchmark": True, "accumulate_grad_batches": 2}},
    }


def _scheduled_ldm():
    cfg = _ldm_yaml(ae=False)
    cfg["model"]["params"]["scheduler_config"] = {
        "target": "ldm.lr_scheduler.LambdaLinearScheduler",
        "params": {"warm_up_steps": [10000], "cycle_lengths": [10000000000000], "f_start": [1e-6], "f_max": [1.0],
                   "f_min": [1.0]}}
    return cfg


FIXTURES = {
    "ccdm_train": lambda: _ccdm_params(),
    "ccdm_train_torch_ckpt": lambda: _ccdm_params(load_from="/mnt/ck.pt", wandb=True, multigpu=True),
    "ccdm_eval": lambda: {**_ccdm_params(evaluations=3, evaluation_vote_strategy="confidence", dataset_split="val",
                                         time_steps=250, load_from="/mnt/model_checkpoint_713000.pt"),
                          "feature_cond_encoder": {"type": "none"}},
    "ldm_pixel": lambda: _ldm_yaml(ae=False),
    "ldm_scheduled": _scheduled_ldm,
    "ldm_ae": lambda: _ldm_yaml(ae=True),
    "ae": _ae_ref,
}


def _jax_wording(warning: str) -> str:
    """A port warning with its convert hint in the JAX importer's words."""
    head, tail = tref._CONVERT_HINT.split("{key}")
    jhead, jtail = jref._CONVERT_HINT.split("{key}")
    return re.sub(re.escape(head) + r"(.*?)" + re.escape(tail), lambda m: jhead + m.group(1) + jtail, warning)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_translation_matches_jax(name):
    cfg = FIXTURES[name]()
    assert tref.detect_kind(cfg) == jref.detect_kind(cfg)
    got, got_warns = tref.import_reference_config(cfg)
    want, want_warns = jref.import_reference_config(FIXTURES[name]())
    assert got == want
    assert [_jax_wording(w) for w in got_warns] == want_warns
    hinted = [w for w in got_warns if "convert_reference" in w]
    assert len(hinted) == sum("convert_reference_checkpoint" in w for w in want_warns)
    assert all("jointimagegeneration_torch.cli.convert_reference" in w for w in hinted)


def test_detect_kind_rejects_unknown():
    for mod in (tref, jref):
        with pytest.raises(ValueError, match="unrecognized reference config"):
            mod.detect_kind({"foo": 1})


def test_main_writes_yaml_and_names_the_port_cli(tmp_path, capsys):
    src = tmp_path / "params.yml"
    src.write_text(yaml.safe_dump(_ccdm_params()))
    dst = tmp_path / "stage1.yml"
    tref._main([str(src), "-o", str(dst)])
    cap = capsys.readouterr()
    assert "ccdm_train: wrote" in cap.out
    assert "python -m jointimagegeneration_torch.cli.train_mask" in cap.err
    assert yaml.safe_load(dst.read_text()) == jref.import_reference_config(_ccdm_params())[0]
    ae = tmp_path / "ae.yaml"
    ae.write_text(yaml.safe_dump(_ae_ref()))
    out = subprocess.run([sys.executable, "-m", "jointimagegeneration_torch.core.ref_import", str(ae)], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert yaml.safe_load(out.stdout) == jref.import_reference_config(_ae_ref())[0]
    assert "python -m jointimagegeneration_torch.cli.train_ae <cfg>" in out.stderr
    assert "NOTE: model.params.ckpt_path" in out.stderr and "cli.convert_reference" in out.stderr


def test_translated_ccdm_train_config_trains_two_steps(tmp_path):
    from jointimagegeneration_torch.cli import train_mask

    cfg, _ = tref.import_reference_config(_ccdm_params())
    assert cfg["remat"] is True  # the translated config's rematerialisation trains as it is
    apply_overrides(cfg, [f"output_path={tmp_path}", "bf16=false", "max_steps=2", "save_freq=2",
                          "display_freq=1", "validation_freq_steps=2", "eval_time_steps=2", "n_validation_images=1",
                          "mp_loaders=1", "time_steps=20", "unet_openai.base_channels=8",
                          "unet_openai.channel_mult=[1,2]", "unet_openai.attention_resolutions=[1]",
                          "unet_openai.num_head_channels=4", "feature_cond_encoder.embed_dim=16",
                          "feature_cond_encoder.n_heads=2", "feature_cond_encoder.d_head=8",
                          "feature_cond_encoder.model_depth=1",
                          "dataset={kind: synthetic, volume_shape: [8, 8, 8], num_cases: 3, context_len: 6}"])
    state = train_mask.run(cfg, "e1", device="cpu")
    assert state.step == 2 and any(n.startswith("refiner.") for n in state.names)
    recs = [json.loads(line) for line in (tmp_path / "e1" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r)
    assert [r["step"] for r in recs if "val/dice" in r] == [2]


def test_translated_ldm_pixel_config_trains_two_steps(tmp_path):
    from jointimagegeneration_torch.cli import train_ldm

    cfg, _ = tref.import_reference_config(_scheduled_ldm())
    apply_overrides(cfg, [f"output_path={tmp_path}", "model.bf16=false", "max_steps=2", "save_freq=2",
                          "display_freq=1", "eval_every=2", "n_log_images=2", "log_ddim_steps=2", "num_workers=1",
                          "model.timesteps=100", "model.unet_config.params.model_channels=8",
                          "model.unet_config.params.channel_mult=[1,2]",
                          "model.unet_config.params.attention_resolutions=[1]",
                          "model.unet_config.params.num_head_channels=4", "model.unet_config.params.num_res_blocks=1",
                          "dataset={kind: synthetic, slice_shape: [16, 16], depth: 4, num_cases: 3}"])
    state = train_ldm.run(cfg, "e1", device="cpu")
    assert state.step == 2 and state.optimizer.count == 2
    recs = [json.loads(line) for line in (tmp_path / "e1" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2]
    assert [r["step"] for r in recs if "val/loss_simple" in r] == [2]
    # the warmup-linear schedule from scheduler_config: lr x f_start at the first update
    assert state.optimizer.schedule(0) == pytest.approx(cfg["model"]["base_learning_rate"] * 1e-6)
