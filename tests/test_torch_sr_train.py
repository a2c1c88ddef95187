"""PyTorch port: stage-2 training on the stock ImageNet datasets through `cli.train_ldm`.

`configs/stage2_sr_imagenet.yml` (dataset kind `imagenet_sr`: HR RGB, cond
the bicubic-upsampled BSRGAN-light LR) and its unconditional `imagenet`
twin (`cond_channels: 0`), cut to tiny widths (UNet base 8 on 32x32 slices,
fp32, b = 2) over a `<synset>/<file>` tree written in `tmp_path`, on the CPU.
The CLI's first step, from the JAX init's weights with the JAX step's draws
replayed, logs the loss of the JAX step (`make_ldm_train_step`'s loss_fn on
the JAX dataset's items of the loader's first batch) within 1e-5 relative;
then a run trains, validates (the panels of an RGB image from channel 0; the
unconditional items carry no cond) and resumes."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from jointimagegeneration_torch.cli import train_ldm as tcli
from jointimagegeneration_torch.train import trainer as ttrainer
from jointimagegeneration_tpu.cli.common import build_slice_dataset as jbuild
from jointimagegeneration_tpu.cli.common import build_slice_ldm as jbuild_ldm
from jointimagegeneration_tpu.train import losses as jlosses

from test_torch_ldm_train import _ldm_draws
from test_torch_stock_data import _write_image
from test_torch_weights import ReplayNoise, init_flax, load_port

ROOT = Path(__file__).resolve().parents[1]
UNET = {"model_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2], "num_res_blocks": 1,
        "num_head_channels": 4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inet(tmp_path_factory):
    root = tmp_path_factory.mktemp("inet")
    for s, syn in enumerate(("n01440764", "n01443537")):
        for j in range(3):
            _write_image(root / syn / f"{syn}_{j}.JPEG", 48 + 7 * j, 56 - 5 * s, seed=10 * s + j)
    return root


def _cfg(out, inet, kind: str, **top) -> dict:
    cfg = yaml.safe_load((ROOT / "configs" / "stage2_sr_imagenet.yml").read_text())
    cfg.update({"output_path": str(out), "batch_size": 2, "max_steps": 1, "display_freq": 1, "save_freq": 2,
                "eval_every": 2, "n_log_images": 2, "log_ddim_steps": 2, "num_workers": 1, "device": "cpu", **top})
    cfg["model"].update(bf16=False, timesteps=100)
    cfg["model"]["unet_config"]["params"] = dict(UNET)
    cfg["dataset"].update(root=str(inet), size=32)
    if kind == "imagenet":  # the unconditional twin: RGB, no cond
        cfg["model"]["cond_channels"] = 0
        cfg["dataset"] = {"kind": "imagenet", "root": str(inet), "size": 32}
    return cfg


def _jax_first_step_loss(cfg: dict, p, key) -> float:
    """make_ldm_train_step's loss_fn (JAX steps.py:88-100) on the JAX
    dataset's items of the loader's first batch (default_rng(seed) order)."""
    jm = jbuild_ldm(cfg["model"])
    ds = jbuild(cfg, "train")
    idx = np.random.default_rng(cfg["seed"]).permutation(len(ds))[:cfg["batch_size"]]
    items = [ds[int(i)] for i in idx]
    x0 = jnp.asarray(np.stack([it["image"] for it in items]))
    cond = jnp.asarray(np.stack([it["cond"] for it in items])) if "cond" in items[0] else None
    diff = jm.diffusion
    kt, kn = jax.random.split(key)
    t = jax.random.randint(kt, (x0.shape[0],), 0, diff.num_timesteps)
    noise = jax.random.normal(kn, x0.shape, x0.dtype)
    out = jm.apply_model({"params": p}, diff.q_sample(x0, t, noise), t, cond=cond)
    loss, _ = jlosses.gaussian_diffusion_loss(out, noise, t, diff.lvlb_weights, "l2")
    return float(loss)


def _records(logdir: Path) -> list:
    return [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("kind", ["imagenet_sr", "imagenet"])
def test_first_step_loss_matches_jax(tmp_path, inet, monkeypatch, kind):
    cfg = _cfg(tmp_path / "runs", inet, kind, validate=False)
    jm = jbuild_ldm(cfg["model"])
    c = jm.cond_channels
    p = init_flax(jm.unet, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1,)),
                  cond=jnp.zeros((1, 32, 32, c)) if c else None, seed=2)
    key = jax.random.key(17)
    want = _jax_first_step_loss(cfg, p, key)
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
    got = [r["train/loss"] for r in _records(tmp_path / "runs" / "e1") if "train/loss" in r]
    assert len(got) == 1
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["imagenet_sr", "imagenet"])
def test_cli_trains_validates_and_resumes(tmp_path, inet, capsys, kind):
    cfg = _cfg(tmp_path / "runs", inet, kind, max_steps=2)
    state = tcli.run(cfg, "e1")
    assert state.step == 2
    logdir = tmp_path / "runs" / "e1"
    recs = _records(logdir)
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2]
    val = [r for r in recs if "val/loss_simple" in r]
    assert [r["step"] for r in val] == [2] and np.isfinite(val[0]["val/loss_simple"])
    pngs = sorted(p.name for p in (logdir / "images").glob("*.png"))
    for panel in ("inputs", "samples", "inpaint", "outpaint", "denoise_row"):
        assert any(panel in n for n in pngs), (panel, pngs)
    assert not any("overlay" in n for n in pngs), pngs  # an RGB cond (or none) is no mask
    tcli.run({**cfg, "resume": True, "max_steps": 3}, "e1")
    assert "resumed from step 2" in capsys.readouterr().out
