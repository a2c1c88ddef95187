"""PyTorch port: latent (`_ae`) stage-2 training (`LatentSliceLDM.
train_loss_inputs`, `make_latent_ldm_train_step`, the latent branch of
`cli.train_ldm` with `scale_by_std`) held against the JAX package on the CPU.

The JAX step runs from the same UNet and AE parameters (`init_flax`) and the
port replays its draws (`ReplayNoise`): the first stage's posterior normal
(key `ke`), then the stage-2 step's randint timesteps and normals (key `kl`).
Gradients are read from Adam's first moment after one step, (1 - b1) x g in
both frameworks.  Tolerances:
  * fp32: the loss and every gradient within 1e-5 of the tensor's max |.|
    (the attention sites hold 64 tokens, so both sides take plain attention;
    the UNet is 64 wide, so no GroupNorm group holds one channel and no bias
    gradient is zero in exact arithmetic but for the attention's key bias,
    which is left out);
  * bf16: the loss within 1e-3 of the JAX bf16 loss, every gradient within
    3e-2 of its max against the JAX *fp32* gradients, or within 1.5x the JAX
    bf16 gradient's own distance from them where that is larger (ROADMAP.md
    section 3, "bf16 gradients" and "bf16 gradients into the refiner"; the
    AEs run in fp32 in both);
  * `scale_by_std`: the factor `cli.train_ldm` writes within 1e-6 of the JAX
    calibration (`LatentSliceLDM.calibrate_scale_factor`) on the same batch.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import sample as tsample
from jointimagegeneration_torch.cli import train_ldm as tcli
from jointimagegeneration_torch.models.autoencoder import AutoencoderKL as TKL
from jointimagegeneration_torch.models.latent_ldm import LatentSliceLDM as TLatent
from jointimagegeneration_torch.models.slice_ldm import SliceLDM as TSlice
from jointimagegeneration_torch.train.optim import build_optimizer as t_opt
from jointimagegeneration_torch.train.state import EMATrainState as TState
from jointimagegeneration_torch.train.steps import make_latent_ldm_train_step as t_step
from jointimagegeneration_torch.utils.jax_weights import (_find_states, ae_state_dict_from_jax, flatten_tree,
                                                          unet_state_dict_from_jax)
from jointimagegeneration_tpu.models.autoencoder import AutoencoderKL
from jointimagegeneration_tpu.models.latent_ldm import LatentSliceLDM
from jointimagegeneration_tpu.train.optim import build_optimizer
from jointimagegeneration_tpu.train.state import EMATrainState
from jointimagegeneration_tpu.train.steps import make_latent_ldm_train_step

from test_torch_weights import ReplayNoise, init_flax, load_port, to_numpy, to_torch

LDM = dict(image_channels=3, cond_channels=2, timesteps=100, model_channels=64, channel_mult=(1,),
           attention_resolutions=(1,), num_res_blocks=1, num_head_channels=16)
AE = dict(embed_dim=3, ch=8, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), z_channels=3, resolution=16)
COND_AE = dict(AE, embed_dim=2, z_channels=2)
B1 = 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX latent models (fp32, bf16 UNet; fp32 AEs), their parameters, one
    pixel batch and a cache of JAX step results."""
    ae, cond_ae = AutoencoderKL(in_channels=1, out_ch=1, **AE), AutoencoderKL(in_channels=2, out_ch=2, **COND_AE)
    models = {name: LatentSliceLDM.create(first_stage=ae, cond_stage=cond_ae, scale_factor=0.7, dtype=dtype, **LDM)
              for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16))}
    p = init_flax(models["float32"].inner.unet, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)), cond=jnp.zeros((1, 8, 8, 2)))
    ae_p = init_flax(ae, jnp.zeros((1, 16, 16, 1)), seed=3)
    cond_p = init_flax(cond_ae, jnp.zeros((1, 16, 16, 2)), seed=4)
    rs = np.random.RandomState(5)
    batch = {"image": rs.rand(2, 16, 16, 1).astype(np.float32), "cond": rs.rand(2, 16, 16, 2).astype(np.float32)}
    return models, p, ae_p, cond_p, batch, {}


def _jax_step(setup, dtype: str):
    """(loss, gradients) of one JAX latent step (Adam, so the gradient is its
    first moment over 1 - b1)."""
    models, p, ae_p, cond_p, batch, cache = setup
    if dtype not in cache:
        state = EMATrainState.create({"params": p}, build_optimizer("Adam", 1e-3), ema_decay=0.9)
        step = make_latent_ldm_train_step(models[dtype], {"params": ae_p}, {"params": cond_p})
        state2, metrics = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(11))
        mu = jax.device_get(_find_states(state2.opt_state, "mu")[0].mu)
        grads = {k: v / (1 - B1) for k, v in unet_state_dict_from_jax(mu).items()}
        cache[dtype] = float(metrics["loss"]), grads
    return cache[dtype]


def _draws(key, z_shape, timesteps):
    """The JAX latent step's draws in order: ke's posterior normal, then the
    inner step's (kt, kn) split of kl."""
    ke, kl = jax.random.split(key)
    kt, kn = jax.random.split(kl)
    return [("normal", np.asarray(jax.random.normal(ke, z_shape, jnp.float32))),
            ("randint", np.asarray(jax.random.randint(kt, (z_shape[0],), 0, timesteps))),
            ("normal", np.asarray(jax.random.normal(kn, z_shape, jnp.float32)))]


def _port(setup, dtype):
    _, p, ae_p, cond_p, _, _ = setup
    inner = TSlice.create(dtype=dtype, device="cpu", **LDM)
    load_port(inner.unet, p)
    ae = TKL(in_channels=1, out_ch=1, device="cpu", **AE)
    ae.load_state_dict(ae_state_dict_from_jax(ae_p))
    cond_ae = TKL(in_channels=2, out_ch=2, device="cpu", **COND_AE)
    cond_ae.load_state_dict(ae_state_dict_from_jax(cond_p))
    for stage in (ae, cond_ae):
        stage.eval().requires_grad_(False)
    return TLatent(inner=inner, first_stage=ae, cond_stage=cond_ae, scale_factor=0.7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_latent_step_matches_jax(setup, dtype):
    bf16 = dtype == torch.bfloat16
    jloss, jgrads = _jax_step(setup, "bfloat16" if bf16 else "float32")
    jbf16 = jgrads
    if bf16:
        _, jgrads = _jax_step(setup, "float32")
    latent = _port(setup, dtype)
    named = latent.inner.named_parameters()
    state = TState(t_opt(named, "Adam", 1e-3), ema_decay=0.9)
    seen, apply = [], state.apply_gradients
    state.apply_gradients = lambda g: seen.append({k: v.detach().clone() for k, v in g.items()}) or apply(g)
    noise = ReplayNoise(_draws(jax.random.key(11), (2, 8, 8, 3), 100))
    metrics = t_step(latent)(state, {k: to_torch(v) for k, v in setup[4].items()}, noise)
    assert not noise.draws and float(metrics["grad_finite"]) == 1.0
    assert all(p.grad is None for p in latent.first_stage.parameters())  # frozen: outside the state
    assert sorted(seen[0]) == sorted(jgrads) == sorted(n for n, _ in named)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-3 if bf16 else 1e-5)
    for n, g in seen[0].items():
        got, want = to_numpy(g), jgrads[n].numpy()
        own = jbf16[n].numpy()
        if n.endswith("qkv.bias"):  # the key third: softmax cancels it (zero in exact arithmetic)
            keep = np.r_[0:want.shape[0] // 3, 2 * want.shape[0] // 3:want.shape[0]]
            got, want, own = got[keep], want[keep], own[keep]
        scale = np.abs(want).max()
        limit = max(3e-2 * scale, 1.5 * np.abs(own - want).max()) if bf16 else 1e-5 * scale
        assert np.abs(got - want).max() <= limit, n


def test_train_loss_inputs_are_the_frozen_encodings(setup):
    """z0 is the scaled posterior sample (the only draw), the cond latent the
    cond stage's unscaled mode, both fp32 and without a graph; without a
    condition, None."""
    models, _, ae_p, cond_p, batch, _ = setup
    latent = _port(setup, torch.bfloat16)
    eps = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
    noise = ReplayNoise([("normal", eps)])
    z0, cz = latent.train_loss_inputs(to_torch(batch["image"]), noise, to_torch(batch["cond"]))
    assert not noise.draws and z0.dtype == cz.dtype == torch.float32 and not z0.requires_grad
    jm = models["float32"]
    post = jax.jit(lambda pp, x: jm.first_stage.apply(pp, x, method=jm.first_stage.encode))(
        {"params": ae_p}, jnp.asarray(batch["image"]))
    want_z = 0.7 * (np.asarray(post.mean) + np.exp(0.5 * np.asarray(post.logvar)) * eps)
    want_c = jax.jit(lambda pp, c: jm.encode_cond(pp, c))({"params": cond_p}, jnp.asarray(batch["cond"]))
    for got, want in ((z0, want_z), (cz, want_c)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5 * np.abs(want).max(), rtol=0)
    z_only, none = latent.train_loss_inputs(to_torch(batch["image"]), ReplayNoise([("normal", eps)]))
    assert none is None and torch.equal(z_only, z0)


def test_cli_trains_the_latent_route_and_sampling_reads_its_scale(tmp_path, capsys):
    """`cli.train_ldm` with first_stage (a JAX `.npz` AE), cond_stage and
    scale_by_std: the factor it prints and writes equals the JAX calibration
    on the same batch, two steps and a validation run, and `stage: ct` from
    its checkpoints reads the same factor back."""
    ae_j = AutoencoderKL(in_channels=1, out_ch=1, **AE)
    ae_p = init_flax(ae_j, jnp.zeros((1, 16, 16, 1)), seed=6)
    npz = tmp_path / "ae.npz"
    np.savez(npz, **{"/".join(("params",) + k): v for k, v in flatten_tree(ae_p).items()})
    dd = {k: list(v) if isinstance(v, tuple) else v for k, v in AE.items() if k != "embed_dim"}
    cfg = {"output_path": str(tmp_path / "runs"), "seed": 0, "batch_size": 2, "max_steps": 2, "save_freq": 2,
           "display_freq": 1, "eval_every": 2, "n_log_images": 2, "log_ddim_steps": 2, "num_workers": 1,
           "dataset": {"kind": "synthetic", "slice_shape": [16, 16], "depth": 4, "num_cases": 3},
           "model": {"timesteps": 20, "channels": 3, "cond_channels": 2, "bf16": False, "scale_by_std": True,
                     "base_learning_rate": 1e-4,
                     "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2],
                                                "attention_resolutions": [2], "num_res_blocks": 1,
                                                "num_head_channels": 4}},
                     "first_stage": {"embed_dim": 3, "checkpoint": str(npz),
                                     "ddconfig": {**dd, "in_channels": 1, "out_ch": 1}},
                     "cond_stage": {"embed_dim": 2, "ddconfig": {**dd, "z_channels": 2, "in_channels": 2,
                                                                 "out_ch": 2}}}}
    state = tcli.run(cfg, "e1", device="cpu")
    out = capsys.readouterr().out
    assert state.step == 2 and "FRESH-INIT" in out  # the cond stage: no trained weights
    logdir = tmp_path / "runs" / "e1"
    factor = json.loads((logdir / "checkpoints" / "latent_scale.json").read_text())["scale_factor"]
    assert f"scale_by_std: calibrated scale_factor={factor!r}" in out
    ds = tcli.build_slice_dataset(cfg, "train")
    calib = jnp.stack([jnp.asarray(ds[i]["image"]) for i in range(2)])
    want = LatentSliceLDM(inner=None, first_stage=ae_j).calibrate_scale_factor({"params": ae_p}, calib).scale_factor
    np.testing.assert_allclose(factor, want, rtol=1e-6)
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "train/loss" in r] == [1, 2]
    assert [r["step"] for r in recs if "val/loss_simple" in r] == [2]
    assert sorted(p.name for p in (logdir / "images").glob("*.png")) == [
        "val_inputs_gs-000002.png", "val_reconstruction_gs-000002.png", "val_samples_gs-000002.png"]
    s2 = {**cfg["model"], "slice_size": 16, "checkpoint": str(logdir / "checkpoints"), "dataset": cfg["dataset"]}
    del s2["scale_by_std"]
    tsample.run({"stage": "ct", "n_cases": 1, "ddim_steps": 2, "seed": 3, "metrics": False, "slices": 2,
                 "output_path": str(tmp_path / "samples"), "stage2": s2}, device="cpu")
    printed = capsys.readouterr().out
    found = re.search(r"latent scale_factor (\S+) from (\S+)", printed)
    assert found and float(found.group(1)) == factor and found.group(2).endswith("latent_scale.json")
    assert (tmp_path / "samples" / "case_0000" / "image.nii.gz").exists()
