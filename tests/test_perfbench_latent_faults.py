"""The comparison that decides `correct` in the latent `_ae` cell
(`perfbench/drivers/latent_slices.py`), at a size a test run holds, on the
CPU: a sound run passes, the control (the fp8 reference in the program's
place) fails, and each kept fault planted in the program's latent route comes
out not correct: the autoencoders computing in bf16 (below the fp32 the
configuration states), a decode skipped (the latent passed on, upsampled),
a DDIM step that returns its state unchanged, and one pixel of a slice
altered.

The tiny configuration keeps the published autoencoders' form (two ResBlocks'
worth of levels, a placed attention site and the one-head mid attention)
with at least two channels a GroupNorm group, as every published width has:
at one channel a group, the first slice's all-zero [prev | mask] pair makes
each group constant and its normalisation ill-conditioned.  Its limits lie
between the sound program's readings and the faults' (the readings beside
each)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness

CFG = {"dtype": "bfloat16", "ae_dtype": "float32", "model_channels": 16, "channel_mult": [1, 2], "num_res_blocks": 1,
       "attention_resolutions": [2], "num_head_channels": 8, "image_channels": 4, "cond_channels": 4,
       "timesteps": 1000, "beta_schedule": "linear", "linear_start": 0.0015, "linear_end": 0.0195, "scale_factor": 1.0,
       "first_stage": {"embed_dim": 4, "ddconfig": {"ch": 64, "ch_mult": [1, 1, 2], "num_res_blocks": 1,
                                                    "attn_resolutions": [16], "z_channels": 4, "in_channels": 1,
                                                    "out_ch": 1, "resolution": 32}},
       "cond_stage": {"embed_dim": 4, "ddconfig": {"ch": 64, "ch_mult": [1, 1, 2], "num_res_blocks": 1,
                                                   "attn_resolutions": [16], "z_channels": 4, "in_channels": 2,
                                                   "out_ch": 2, "resolution": 32}}}
# sound tiny runs read slice_rms ~1.5e-3, slice_max_abs ~5e-3 (the bf16 UNet), decode_rel_max ~1e-6 and
# cond_rel_max ~1e-5 (fp32 AEs); the fp8 control ~5e-2, 0.17, 0.2 and 0.3
WORKLOAD = {"driver": "latent_slices", "rate_metric": "ct_slices_per_s", "batch": 2, "slice_size": 32, "depth": 8,
            "mask_shape": [4, 8, 8], "num_classes": 12, "ddim_steps": 4, "ddim_eta": 0.0, "check_slices": 2,
            "limits": {"slice_rms": 0.01, "slice_max_abs": 0.05, "decode_rel_max": 1e-4, "cond_rel_max": 1e-4,
                       "handoff_max_abs": 0.0}}
CELL = "latent_ae_512.sample_512_b4"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(seed: int = 2**31 + 4321, seconds: float = 0.3) -> harness.Run:
    return harness.Run({"name": CELL, "chips": 1}, CFG, WORKLOAD, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter())


def execute(run: harness.Run) -> dict:
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    e2e, _ = harness.cell_metrics(bench, CELL)
    return harness.execute(run, harness.load_part("drivers", "latent_slices"), {}, e2e)


def ae_bf16(monkeypatch):
    """Both autoencoders compute in bf16: their inputs rounded, every conv,
    norm and attention in bf16, the outputs returned in fp32."""
    from jointimagegeneration_torch.models import latent_ldm

    encode, decode = latent_ldm.ae_encode, latent_ldm.ae_decode

    def encode_bf16(stage, x, noise=None):
        return encode(stage, x.bfloat16(), noise).float()

    def decode_bf16(stage, z):
        return decode(stage, z.bfloat16()).float()

    for name, fn in (("ae_encode", encode_bf16), ("ae_decode", decode_bf16)):
        fn.launches = 0  # the program counts its calls under the name it looks up
        monkeypatch.setattr(latent_ldm, name, fn)


def decode_skipped(monkeypatch):
    """The first stage's decode left out: the latent's first channels passed
    on, repeated to the slice's size."""
    from jointimagegeneration_torch.models import latent_ldm

    def skipped(stage, z):
        f = stage.downsample_factor
        return z[..., :stage.out_ch].repeat_interleave(f, 1).repeat_interleave(f, 2)

    monkeypatch.setattr(latent_ldm, "ae_decode", skipped)


def ddim_unchanged(monkeypatch):
    from jointimagegeneration_torch.models import slice_ldm

    monkeypatch.setattr(slice_ldm, "ddim_step", lambda params, noise, x, e, index, temperature=1.0: (x, x))


def pixel_altered(monkeypatch):
    from jointimagegeneration_torch.models import latent_ldm

    minmax = latent_ldm._minmax_slice

    def altered(s):
        out = minmax(s).clone()
        out[0, 0, 0, 0] = 1.0 - out[0, 0, 0, 0]
        return out

    monkeypatch.setattr(latent_ldm, "_minmax_slice", altered)


FAULTS = [ae_bf16, decode_skipped, ddim_unchanged, pixel_altered]


def test_sound_run_is_correct_and_control_is_not():
    run = tiny_run()
    result = execute(run)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 2 * WORKLOAD["batch"]
    control = harness.compare(run, harness.load_part("drivers", "latent_slices"), control=True)[1]
    assert harness.failures(control) > 0, control


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_broken_latent_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = execute(tiny_run())
    assert not result["correct"], result["checks"]


def test_ae_bf16_fails_an_autoencoder_check(monkeypatch):
    """Computing the AEs below their stated fp32 fails `decode_rel_max` or
    `cond_rel_max` itself, not only the slices' gaps."""
    ae_bf16(monkeypatch)
    checks = execute(tiny_run())["checks"]
    assert any(not checks[n]["value"] <= checks[n]["limit"] for n in ("decode_rel_max", "cond_rel_max")), checks


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((harness.ROOT / "perfbench" / "reference" / "vae.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not {name.split(".")[0] for name in names} & set(harness.FORBIDDEN + ("jointimagegeneration_torch",))


def test_a_traced_run_loads_no_jax():
    """The traffic module, its readers and the program's latent route, in a
    process of their own: no JAX, no JAX package."""
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(2)\n"
            "import test_perfbench_latent_faults as t\n"
            "from perfbench import harness\n"
            "run = t.tiny_run(seconds=0.1); run.trace = True\n"
            "t.execute(run)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % (str(harness.ROOT), str(harness.ROOT / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "jointimagegeneration_torch" in top and "perfbench" in top
    assert not top & set(harness.FORBIDDEN)
