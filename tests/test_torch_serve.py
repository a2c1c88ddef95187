"""PyTorch port: the inference server (`cli/serve.py`) against the JAX server.

Both servers run in threads on 127.0.0.1 at tiny fp32 widths on the CPU (a
(4, 8, 8) mask, 16x16 CT slices, 8-channel UNets, 3 mask steps, 3 sampler
nodes), with the same weights (the port's read from flat `.npz` files of the
JAX trees through `build_state`) and the JAX server's random draws replayed
through `serve.request_noise`.  Each request's response keys, labels (equal)
and CT (within 1e-4: the [0, 1] min-max normalised slices; the fp32 UNets sum
in another order at each node) are held to the JAX server's; the NDJSON
stream's line keys, shapes and dtypes too, and its slices equal the port's
unstreamed volume bit for bit.  Then the error statuses (404, 400, 500) and
a mid-stream error line, and the start-up rules (no CUDA, no start)."""

import base64
import contextlib
import http.client
import json
import threading
from http.server import HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import serve as tserve
from jointimagegeneration_torch.utils.jax_weights import flatten_tree
from jointimagegeneration_tpu.cli import serve as jserve
from jointimagegeneration_tpu.cli.common import build_mask_sampler, build_slice_ldm
from jointimagegeneration_tpu.data.nifti import read_nifti
from jointimagegeneration_tpu.diffusion.ddim import DDIMParams
from jointimagegeneration_tpu.models.latent_ldm import LatentSliceLDM
from jointimagegeneration_tpu.pipeline import TwoStagePipeline

from test_torch_latent import COND_CH, SF, two_pass_group_norm
from test_torch_weights import ReplayNoise, init_flax, jax_mask_draws, jax_volume_draws

UNET = {"model_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2], "num_head_channels": 4,
        "num_res_blocks": 1}
SPATIAL, VOLUME, NC, STEPS = (4, 8, 8), (4, 16, 16), 4, 3
CT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ae(cin, ch):
    return {"embed_dim": 4, "ddconfig": {"ch": ch, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [8],
                                         "z_channels": 4, "in_channels": cin, "out_ch": cin, "resolution": 16}}


def _config(latent: bool) -> dict:
    s2 = {"slice_size": 16, "timesteps": 100, "bf16": False, "unet_config": {"params": UNET}}
    if latent:
        s2.update(channels=4, cond_channels=4, first_stage={**_ae(1, 8), "scale_factor": SF},
                  cond_stage=_ae(2, COND_CH))
    return {"seed": 3, "mask_steps": STEPS, "ddim_steps": 3, "ddim_discretize": "uniform_lambda",
            "volume_shape": list(VOLUME), "device": "cpu",
            "stage1": {"num_classes": NC, "time_steps": 20, "bf16": False, "dataset": {"volume_shape": list(SPATIAL)},
                       "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                                       "num_head_channels": 4, "num_res_blocks": 1}},
            "stage2": s2}


def _npz(path, tree) -> str:
    np.savez(path, **{"/".join(k): v for k, v in flatten_tree(tree).items()})
    return str(path)


def _servers(tmp_path, latent: bool):
    """(JAX server state, port server state) with the same weights."""
    cfg = _config(latent)
    s1, s2 = cfg["stage1"], cfg["stage2"]
    jms, jinner = build_mask_sampler(s1), build_slice_ldm(s2)
    pm = init_flax(jms.unet, jnp.zeros((1, *SPATIAL, NC)), jnp.zeros((1,)), cond=jnp.zeros((1, *SPATIAL, 1)))
    size = 8 if latent else 16
    pu = init_flax(jinner.unet, jnp.zeros((1, size, size, jinner.channels)), jnp.zeros((1,)),
                   cond=jnp.zeros((1, size, size, jinner.cond_channels)), seed=1)
    s1["checkpoint"] = _npz(tmp_path / "s1.npz", {"params": pm})
    s2["checkpoint"] = _npz(tmp_path / "s2.npz", {"params": pu})
    jstate = {"ms": jms, "ms_params": {"params": pm}, "spatial": SPATIAL, "mask_steps": STEPS, "feat_fn": None,
              "feat_idx": None, "ldm_params": {"params": pu}, "volume_shape": VOLUME}
    jldm = jinner
    if latent:
        from jointimagegeneration_tpu.cli.common import build_autoencoder

        jae, jcae = build_autoencoder(s2["first_stage"]), build_autoencoder(s2["cond_stage"])
        pae = init_flax(jae, jnp.zeros((1, 16, 16, 1)), seed=10)
        pcae = init_flax(jcae, jnp.zeros((1, 16, 16, 2)), seed=11)
        s2["first_stage"]["checkpoint"] = _npz(tmp_path / "ae.npz", {"params": pae})
        s2["cond_stage"]["checkpoint"] = _npz(tmp_path / "cae.npz", {"params": pcae})
        jldm = LatentSliceLDM(inner=jinner, first_stage=jae, cond_stage=jcae, scale_factor=SF)
        jstate.update(ae_params={"params": pae}, cond_ae_params={"params": pcae})
    jstate.update(ldm=jldm, pipe=TwoStagePipeline(jms, jldm),
                  ddim=DDIMParams.create(jinner.diffusion, 3, method="uniform_lambda"))
    return jstate, tserve.build_state(cfg)


@contextlib.contextmanager
def _serving(handler):
    server = HTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def _request(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, data


def _volume(b64: str) -> np.ndarray:
    import gzip
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "v.nii"
        path.write_bytes(gzip.decompress(base64.b64decode(b64)))
        return read_nifti(path)[0]


def _jax_draws(req: dict, latent: bool):
    """The draws the JAX server takes for `req` (serve.py: mask_sampler on
    the request's key; two_stage and stream split it for the two stages)."""
    key = jax.random.key(int(req.get("seed", 0)))
    bs = int(req.get("batch", 1))
    if req["kind"] == "mask":
        return jax_mask_draws(key, (bs, *SPATIAL), NC, STEPS)
    k1, k2 = jax.random.split(key)
    hw, c = (8, 4) if latent else (16, 1)
    return jax_mask_draws(k1, (bs, *SPATIAL), NC, STEPS) + jax_volume_draws(k2, bs, VOLUME[0], hw, hw, c)


class _Replays(list):
    """Set `[0]` to a draw list before a port request; `left()` counts the
    draws the request did not take."""

    def left(self) -> int:
        return len(self.noise.draws)


@pytest.fixture
def replayed(monkeypatch):
    pending = _Replays([None])

    def noise(seed, device):
        pending.noise = ReplayNoise(pending[0])
        return pending.noise

    monkeypatch.setattr(tserve, "request_noise", noise)
    return pending


def _compare(jstate, tstate, reqs, latent, replayed):
    out = []
    ctx = two_pass_group_norm if latent else contextlib.nullcontext
    with _serving(jserve.make_handler(jstate)) as jport, _serving(tserve.make_handler(tstate)) as tport:
        for req in reqs:
            with ctx():
                jcode, jbody = _request(jport, "POST", "/generate", req)
            replayed[0] = _jax_draws(req, latent)
            tcode, tbody = _request(tport, "POST", "/generate", req)
            assert jcode == tcode == 200, (req, jbody[:300], tbody[:300])
            assert not replayed.left(), f"{replayed.left()} JAX draws left unused for {req}"
            j, t = json.loads(jbody), json.loads(tbody)
            assert sorted(j) == sorted(t), (req, sorted(j), sorted(t))
            for k in j:
                if k.endswith("nifti_b64"):
                    jv = [_volume(v) for v in (j[k] if isinstance(j[k], list) else [j[k]])]
                    tv = [_volume(v) for v in (t[k] if isinstance(t[k], list) else [t[k]])]
                    for a, b in zip(jv, tv):
                        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
                        if "labels" in k:
                            np.testing.assert_array_equal(b, a, err_msg=f"{k} {req}")
                        else:
                            np.testing.assert_allclose(b, a, atol=CT_TOL, rtol=0, err_msg=f"{k} {req}")
            if "class_counts" in j:
                assert {int(c): n for c, n in j["class_counts"].items()} == \
                    {int(c): n for c, n in t["class_counts"].items()}
            out.append(t)
    return out


def _stream_lines(port: int, req: dict):
    code, body = _request(port, "POST", "/generate", req)
    return code, [json.loads(line) for line in body.splitlines()]


def _stream_volume(lines) -> np.ndarray:
    arrs = [np.frombuffer(base64.b64decode(ln["data_b64"]), np.float16).reshape(ln["shape"])
            for ln in lines if "slice" in ln]
    return np.stack(arrs, axis=1)  # (B, D, H, W, C)


def test_pixel_server_matches_jax(tmp_path, replayed):
    """mask at b = 1 and 2; two_stage DDIM, PLMS with guidance, DPM with warm
    start at b = 2; then the stream against the JAX stream."""
    jstate, tstate = _servers(tmp_path, latent=False)
    reqs = [{"kind": "mask", "seed": 4}, {"kind": "mask", "seed": 5, "batch": 2},
            {"kind": "two_stage", "seed": 6},
            {"kind": "two_stage", "seed": 7, "sampler": "plms", "guidance_scale": 2.0},
            {"kind": "two_stage", "seed": 8, "batch": 2, "sampler": "dpm", "warm_start": 0.4}]
    outs = _compare(jstate, tstate, reqs, False, replayed)
    assert len(json.loads(json.dumps(outs[1]))["batch_labels_nifti_b64"]) == 2
    assert len(outs[4]["batch_ct_nifti_b64"]) == 2
    req = {"kind": "two_stage", "seed": 6, "stream": True}
    with _serving(jserve.make_handler(jstate)) as jport, _serving(tserve.make_handler(tstate)) as tport:
        jcode, jlines = _stream_lines(jport, req)
        replayed[0] = _jax_draws(req, False)
        tcode, tlines = _stream_lines(tport, req)
    assert jcode == tcode == 200 and not replayed.left()
    assert [sorted(x) for x in jlines] == [sorted(x) for x in tlines]
    assert [x.get("shape") for x in jlines] == [x.get("shape") for x in tlines] == [None, *[[1, 16, 16, 1]] * 4, None]
    assert {x["dtype"] for x in tlines if "slice" in x} == {"float16"}
    np.testing.assert_array_equal(_volume(tlines[0]["labels_nifti_b64"]), _volume(jlines[0]["labels_nifti_b64"]))
    np.testing.assert_allclose(_stream_volume(tlines).astype(np.float32), _stream_volume(jlines).astype(np.float32),
                               atol=1e-3, rtol=0)  # float16 slices: an ulp at 1.0 is 4.9e-4
    # the stream's slices are the unstreamed volume, rounded to float16, bit for bit
    ct = _volume(outs[2]["ct_nifti_b64"])
    np.testing.assert_array_equal(_stream_volume(tlines)[0, ..., 0], ct.astype(np.float16))


def test_latent_server_matches_jax(tmp_path, replayed):
    """The latent `_ae` route (a first_stage and cond_stage under stage2)."""
    jstate, tstate = _servers(tmp_path, latent=True)
    _compare(jstate, tstate, [{"kind": "two_stage", "seed": 9}], True, replayed)


def test_server_errors_and_health(tmp_path):
    _, tstate = _servers(tmp_path, latent=False)
    with _serving(tserve.make_handler(tstate)) as port:
        code, body = _request(port, "GET", "/healthz")
        assert code == 200 and json.loads(body) == {"status": "ok", "device": "cpu"}
        assert _request(port, "GET", "/nope")[0] == 404
        assert _request(port, "POST", "/nope", {})[0] == 404
        code, body = _request(port, "POST", "/generate", {"kind": "volume"})
        assert code == 400 and "unknown kind" in json.loads(body)["error"]
        code, body = _request(port, "POST", "/generate", {"kind": "two_stage", "sampler": "euler"})
        assert code == 500 and "unknown sampler" in json.loads(body)["error"]
        # a failure after the headers: the mask stage ran, the stream carries an error line
        code, lines = _stream_lines(port, {"kind": "two_stage", "stream": True, "warm_start": 2.0})
        assert code == 200 and lines[0]["kind"] == "two_stage_stream"
        assert "warm_start must be in (0, 1]" in lines[-1]["error"] and not any("slice" in x for x in lines)
        # a streamed request at b = 2: one line per slice, (2, H, W, 1) each
        code, lines = _stream_lines(port, {"kind": "two_stage", "stream": True, "batch": 2, "seed": 1})
        assert code == 200 and lines[-1]["done"] and [x["shape"] for x in lines if "slice" in x] == [[2, 16, 16, 1]] * 4
    mask_only = {k: v for k, v in _config(False).items() if k != "stage2"}
    with _serving(tserve.make_handler(tserve.build_state(mask_only))) as port:
        code, body = _request(port, "POST", "/generate", {"kind": "two_stage"})
        assert code == 500 and "stage2" in json.loads(body)["error"]
        assert _request(port, "POST", "/generate", {"kind": "mask", "mask_steps": 2})[0] == 200


def test_server_needs_cuda_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    cfg = {k: v for k, v in _config(False).items() if k != "device"}
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.build_state(cfg)
    path = tmp_path / "serve.yml"
    import yaml

    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main([str(path), "8799"])
