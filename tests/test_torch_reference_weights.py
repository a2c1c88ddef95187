"""PyTorch port: reading the reference's own checkpoints (`utils/torch_convert.py`,
`cli/convert_reference.py`) held against the JAX package's converter on the
CPU.

A tiny reference-named state dict (`test_torch_convert._sd_tiny`, the
guided-diffusion UNet; `test_ae_convert_golden._sd_tiny_ae`, the
AutoencoderKL) goes through the JAX converter into the JAX modules and
through the port's converter and the weight bridge into the port's modules:
the port's converter gives the JAX one's tree leaf for leaf (the same numpy
code), and the outputs agree within 1e-5 of their max |.| (fp32, sums in
another order).  Then the CLI: the entry search, `--ae` with and without a
prefix, the `weights_only` rule, and the `_ae` recipe of three conversions
feeding the port's `stage: ct` sampler.
"""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import convert_reference as tconv
from jointimagegeneration_torch.cli.common import build_autoencoder, load_ae_weights
from jointimagegeneration_torch.cli.sample import build_slice_ldm, load_weights
from jointimagegeneration_torch.models.autoencoder import AutoencoderKL as TKL
from jointimagegeneration_torch.nn.unet import UNet as TUNet
from jointimagegeneration_torch.utils import torch_convert as tconvert
from jointimagegeneration_tpu.models.autoencoder import AutoencoderKL
from jointimagegeneration_tpu.nn.unet import UNet
from jointimagegeneration_tpu.utils import torch_convert as jconvert

from test_ae_convert_golden import CH, EMB, ZC, _sd_tiny_ae
from test_torch_convert import ATTN_DS, HEAD_CH, MC, MULT, NRES, OUT_CH, _sd_tiny
from test_torch_weights import assert_close_scaled, to_numpy, to_torch

TOL = 1e-5
UNET_KW = dict(model_channels=MC, channel_mult=MULT, num_res_blocks=NRES, attention_resolutions=ATTN_DS,
               num_head_channels=HEAD_CH)
AE_KW = dict(embed_dim=EMB, ch=CH, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), z_channels=ZC,
             resolution=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): np.asarray(v)})
    return out


def _as_3d(sd: dict, seed: int = 3) -> dict:
    """`_sd_tiny`'s names with 3D kernels: every 2D conv weight gets a depth
    axis of its own kernel size (ccdm's 3D UNet)."""
    rs = np.random.RandomState(seed)
    return {k: (torch.tensor(rs.randn(*v.shape, v.shape[-1]).astype(np.float32) * 0.2) if v.ndim == 4 else v)
            for k, v in sd.items()}


def _new_order(sd: dict) -> dict:
    """A checkpoint trained with use_new_attention_order: the legacy state
    dict's qkv rows moved to the [q | k | v] head-major layout (the JAX
    converter's permutation)."""
    out = dict(sd)
    for k in sd:
        if k.endswith("qkv.weight") or k.endswith("qkv.bias"):
            c = sd[k].shape[0] // 3
            out[k] = sd[k][torch.from_numpy(jconvert._legacy_qkv_perm(c, c // HEAD_CH))]
    return out


@pytest.mark.parametrize("case", ["legacy", "new_order", "lightning_prefix", "ccdm_3d"])
def test_unet_conversion_matches_jax(case):
    """The port's converter gives the JAX converter's tree, and the port UNet
    on it the JAX UNet's output on the JAX-converted params."""
    dims, prefix, kw = 2, "", dict(UNET_KW)
    sd = _sd_tiny()
    if case == "new_order":
        sd, kw["use_new_attention_order"] = _new_order(sd), True
    elif case == "lightning_prefix":
        prefix = "model.diffusion_model."
        sd = _sd_tiny(prefix=prefix)
    elif case == "ccdm_3d":
        sd, dims = _as_3d(sd), 3
        sd = tconv.reference_state_dict({"model": {"unused": torch.zeros(1)}, "average_model": sd})
    jtree = jconvert.convert_guided_diffusion_unet(sd, **kw)
    ttree = tconvert.convert_guided_diffusion_unet(sd, **kw)
    assert tconvert.find_unet_prefix(sd) == prefix
    jflat, tflat = _flat(jtree), _flat(ttree)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=str(k))
    if case == "new_order":  # the same weights as the legacy checkpoint it came from
        legacy = _flat(tconvert.convert_guided_diffusion_unet(_sd_tiny(), **UNET_KW))
        for k in legacy:
            np.testing.assert_array_equal(tflat[k], legacy[k], err_msg=str(k))
    net = UNet(out_channels=OUT_CH, dims=dims, **UNET_KW)
    spatial = (4, 8, 8) if dims == 3 else (8, 8)
    x = np.random.RandomState(1).randn(2, *spatial, 3).astype(np.float32)
    t = np.array([7.0, 3.0], np.float32)
    want = np.asarray(net.apply({"params": jax.tree.map(jnp.asarray, jtree)}, jnp.asarray(x), jnp.asarray(t)))
    tm = TUNet(in_channels=3, out_channels=OUT_CH, dims=dims, device="cpu", **UNET_KW)
    tm.load_state_dict(tconvert.unet_state_dict_from_reference(sd, **kw))
    with torch.no_grad():
        got = to_numpy(tm(to_torch(x), to_torch(t)))
    assert_close_scaled(got, want, TOL)


@pytest.mark.parametrize("prefix", ["", "first_stage_model.", "cond_stage_model."])
def test_ae_conversion_matches_jax(prefix):
    """A standalone AE checkpoint and one embedded in an LDM checkpoint
    beside a UNet: the same tree as the JAX converter, and the port AE's
    reconstruction (from the posterior's mode) equals the JAX AE's."""
    sd = _sd_tiny_ae(seed=4, prefix=prefix)
    if prefix:
        sd.update(_sd_tiny(prefix="model.diffusion_model."))
        sd[f"{prefix}loss.logvar"] = torch.zeros(())  # the reference's loss module, skipped
    jtree = jconvert.convert_ldm_autoencoder(sd)
    ttree = tconvert.convert_ldm_autoencoder(sd)
    jflat, tflat = _flat(jtree), _flat(ttree)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=str(k))
    jm = AutoencoderKL(in_channels=1, out_ch=1, **AE_KW)
    x = np.random.RandomState(2).rand(2, 16, 16, 1).astype(np.float32)
    want, _ = jax.jit(lambda p, xx: jm.apply({"params": p}, xx))(jax.tree.map(jnp.asarray, jtree), jnp.asarray(x))
    tm = TKL(in_channels=1, out_ch=1, device="cpu", **AE_KW)
    tm.load_state_dict(tconvert.ae_state_dict_from_reference(sd))
    with torch.no_grad():
        got, _ = tm(to_torch(x))
    assert_close_scaled(to_numpy(got), np.asarray(want), TOL)


def test_rejected_layouts_name_their_keys():
    """resblock_updown / SpatialTransformer keys, a 3x3 conv_shortcut and two
    embedded AEs without a prefix raise, naming what they found; --lenient
    skips the leftover keys."""
    sd = _sd_tiny()
    sd["input_blocks.3.1.transformer_blocks.0.attn1.to_q.weight"] = torch.zeros(4, 4)
    sd["input_blocks.2.0.h_upd.weight"] = torch.zeros(4)
    with pytest.raises(ValueError, match=r"unconsumed checkpoint keys.*h_upd.*transformer_blocks"):
        tconvert.convert_guided_diffusion_unet(sd, **UNET_KW)
    assert "in_conv" in tconvert.convert_guided_diffusion_unet(sd, strict=False, **UNET_KW)
    ae = _sd_tiny_ae()
    ae["encoder.down.0.block.0.conv_shortcut.weight"] = torch.zeros(CH, CH, 3, 3)
    with pytest.raises(ValueError, match=r"encoder.down.0.block.0: conv_shortcut"):
        tconvert.convert_ldm_autoencoder(ae)
    both = {**_sd_tiny_ae(prefix="first_stage_model."), **_sd_tiny_ae(prefix="cond_stage_model.")}
    with pytest.raises(ValueError, match=r"embeds 2 AEs \(\['cond_stage_model.', 'first_stage_model.'\]\)"):
        tconvert.convert_ldm_autoencoder(both)
    with pytest.raises(KeyError, match="no AutoencoderKL"):
        tconvert.convert_ldm_autoencoder(_sd_tiny())


def test_weights_only_rule(tmp_path, capsys):
    """A Lightning-style file whose hyper_parameters are a plain dict loads
    with weights_only=True; one that pickles another object is refused,
    naming the global and --unsafe-load, which then loads it with a
    warning."""
    sd = _sd_tiny(prefix="model.diffusion_model.")
    plain = tmp_path / "plain.ckpt"
    torch.save({"state_dict": sd, "epoch": 3, "hyper_parameters": {"base_learning_rate": 2e-6,
                                                                  "unet_config": {"model_channels": MC}}}, plain)
    args = ["--model-channels", str(MC), "--channel-mult", "1,2", "--num-res-blocks", "1",
            "--attention-resolutions", "2", "--num-head-channels", str(HEAD_CH)]
    path = tconv.main([str(plain), str(tmp_path / "a"), *args])
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 0 and saved["params"].keys() == saved["ema"].keys()
    assert "using checkpoint entry 'state_dict'" in capsys.readouterr().out
    pickled = tmp_path / "pickled.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": argparse.Namespace(lr=1.0)}, pickled)
    with pytest.raises(ValueError, match=r"refused the file at the global argparse\.Namespace.*--unsafe-load"):
        tconv.main([str(pickled), str(tmp_path / "b"), *args])
    assert not (tmp_path / "b").exists() or not list((tmp_path / "b").glob("*.pt"))
    path = tconv.main([str(pickled), str(tmp_path / "b"), *args, "--unsafe-load"])
    assert "WARNING: --unsafe-load" in capsys.readouterr().out
    for k, v in torch.load(path, weights_only=True)["ema"].items():
        assert torch.equal(v, saved["ema"][k]), k


def test_entry_search_and_ae_prefix_detection(tmp_path):
    """`state_dict`, then `average_model`, then the root, or `--entry`; `--ae`
    without a prefix finds a standalone AE; the files load into the port's
    modules through the `checkpoint:` keys."""
    sd = _sd_tiny()
    files = {"root": sd, "ignite": {"model": {"x": torch.zeros(1)}, "average_model": sd},
             "entry": {"ema_model": sd, "average_model": {"x": torch.zeros(1)}}}
    s2 = {"timesteps": 20, "bf16": False, "channels": OUT_CH, "cond_channels": 3 - OUT_CH,
          "unet_config": {"params": {**UNET_KW, "channel_mult": list(MULT), "attention_resolutions": list(ATTN_DS)}}}
    want = tconvert.unet_state_dict_from_reference(sd, **UNET_KW)
    for name, obj in files.items():
        torch.save(obj, tmp_path / f"{name}.pt")
        extra = ["--entry", "ema_model"] if name == "entry" else []
        tconv.main([str(tmp_path / f"{name}.pt"), str(tmp_path / name), "--model-channels", str(MC),
                    "--channel-mult", "1,2", "--num-res-blocks", "1", "--attention-resolutions", "2",
                    "--num-head-channels", str(HEAD_CH), *extra])
    ldm = build_slice_ldm({**s2, "channels": 2, "cond_channels": 1}, "cpu")
    with pytest.raises(ValueError):  # out_channels 5 against the 2 of this section
        load_weights(ldm.unet, str(tmp_path / "root"), 0.0, 0)
    unet = TUNet(in_channels=3, out_channels=OUT_CH, dims=2, device="cpu", **UNET_KW)
    for name in files:
        load_weights(unet, str(tmp_path / name), 0.0, 0)
        for k, v in unet.state_dict().items():
            assert torch.equal(v, want[k]), (name, k)
    torch.save({"state_dict": _sd_tiny_ae(seed=2)}, tmp_path / "ae.ckpt")
    tconv.main([str(tmp_path / "ae.ckpt"), str(tmp_path / "ae"), "--ae"])
    ae = build_autoencoder({"embed_dim": EMB, "ddconfig": {**AE_KW, "ch_mult": [1, 2], "attn_resolutions": [8]}},
                           "cpu")
    load_ae_weights(ae, {"checkpoint": str(tmp_path / "ae")})
    for k, v in tconvert.ae_state_dict_from_reference(_sd_tiny_ae(seed=2)).items():
        assert torch.equal(ae.state_dict()[k], v), k
    with pytest.raises(SystemExit):
        tconv.main([str(tmp_path / "root.pt"), str(tmp_path / "c")])  # a UNet needs --model-channels


def test_migration_recipe_end_to_end(tmp_path, capsys):
    """The `_ae` recipe: one combined Lightning-style checkpoint (a latent
    UNet under model.diffusion_model., the two AEs under first_stage_model.
    and cond_stage_model.) converted by three runs, then the port's
    `stage: ct` latent sampler from the converted weights with no FRESH-INIT
    fallback (the counterpart of tests/test_latent_train.py::
    test_migration_recipe_e2e)."""
    from jointimagegeneration_torch.cli import sample as sample_cli
    from jointimagegeneration_torch.data.nifti import read_nifti

    t = lambda *s: torch.tensor(np.random.RandomState(9).randn(*s).astype(np.float32) * 0.2)
    sd = _sd_tiny(prefix="model.diffusion_model.")  # re-headed: in = z(2) + cond_z(2), out = 2
    sd["model.diffusion_model.input_blocks.0.0.weight"] = t(8, 4, 3, 3)
    sd["model.diffusion_model.out.2.weight"] = t(2, 8, 3, 3)
    sd["model.diffusion_model.out.2.bias"] = t(2)
    sd.update(_sd_tiny_ae(seed=4, prefix="first_stage_model."))
    cond_sd = _sd_tiny_ae(seed=5, prefix="cond_stage_model.")  # the 2-channel [prev slice, mask] AE
    cond_sd["cond_stage_model.encoder.conv_in.weight"] = t(8, 2, 3, 3)
    cond_sd["cond_stage_model.decoder.conv_out.weight"] = t(2, 8, 3, 3)
    cond_sd["cond_stage_model.decoder.conv_out.bias"] = t(2)
    sd.update(cond_sd)
    pt = tmp_path / "ldm_ae_full.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": {"scale_factor": 1.0}}, pt)
    tconv.main([str(pt), str(tmp_path / "unet"), "--model-channels", "8", "--channel-mult", "1,2",
                "--num-res-blocks", "1", "--attention-resolutions", "2", "--num-head-channels", "4"])
    tconv.main([str(pt), str(tmp_path / "ae"), "--ae", "first_stage_model."])
    tconv.main([str(pt), str(tmp_path / "cond"), "--ae", "cond_stage_model."])
    dd = {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [8], "z_channels": 2,
          "resolution": 16}
    cfg = {"stage": "ct", "n_cases": 1, "ddim_steps": 2, "seed": 3, "metrics": False,
           "output_path": str(tmp_path / "samples"),
           "stage2": {"slice_size": 16, "timesteps": 8, "bf16": False, "channels": 2, "cond_channels": 2,
                      "checkpoint": str(tmp_path / "unet"),
                      "unet_config": {"params": {"model_channels": 8, "channel_mult": [1, 2],
                                                 "attention_resolutions": [2], "num_res_blocks": 1,
                                                 "num_head_channels": 4}},
                      "first_stage": {"embed_dim": 2, "checkpoint": str(tmp_path / "ae"),
                                      "ddconfig": {**dd, "in_channels": 1, "out_ch": 1}},
                      "cond_stage": {"embed_dim": 2, "checkpoint": str(tmp_path / "cond"),
                                     "ddconfig": {**dd, "in_channels": 2, "out_ch": 2}},
                      "dataset": {"kind": "synthetic", "slice_shape": [16, 16], "depth": 3, "num_cases": 1}}}
    capsys.readouterr()
    sample_cli.run(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "FRESH-INIT" not in out, f"a converted checkpoint failed to load:\n{out}"
    assert len(re.findall(r"AE checkpoint: EMA weights of", out)) == 2
    vol, _ = read_nifti(tmp_path / "samples" / "case_0000" / "image.nii.gz")
    assert np.asarray(vol).shape == (3, 16, 16) and np.all(np.isfinite(np.asarray(vol)))
