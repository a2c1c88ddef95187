"""Inference server: mask and mask -> CT generation over HTTP.

    python -m jointimagegeneration_torch.cli.serve <config.yml> [port] [k=v ...] [device=cpu]

Counterpart of `jointimagegeneration_tpu/cli/serve.py`, with its request and
response contract.  stdlib `http.server`, one single-threaded `HTTPServer`:
one program runs on the card at a time; a request's `batch` is one batched
call.  The models and their weights are built once at start-up
(`build_state`), on CUDA unless `device=cpu` is given; without CUDA and
without `device=cpu` the server refuses to start.  A request with `batch`
> 1 cuts its rows over the data axis of `make_mesh_for_batch(batch)`
(`_batched_mesh`, one mesh per batch size; each card's copy of the UNets'
weights is made once), as the JAX server does; on one card that mesh is
1 x 1 and changes nothing.

POST /generate {"kind": "mask" | "two_stage", "seed": int (0), "batch": int (1),
                "mask_steps": int (the config's, 250), "stream": bool,
                "guidance_scale": float (1.0), "warm_start": float (none),
                "sampler": "ddim" | "plms" | "dpm" (ddim)}
  mask      -> {"labels_nifti_b64", "class_counts", "elapsed_s", "timings"}
  two_stage -> {"ct_nifti_b64", "labels_nifti_b64", "elapsed_s", "timings"}
  with "batch" > 1 also "batch_labels_nifti_b64" (and "batch_ct_nifti_b64"):
  one gzipped NIfTI per volume.  `stream: true` on two_stage answers NDJSON:
  the headers go out once the mask stage is done, then a header line
  {"kind": "two_stage_stream", "n_slices", "batch", "labels_nifti_b64"}, one
  line per CT slice as the autoregressive loop yields it ({"slice", "shape"
  (B, H, W, C), "dtype": "float16", "data_b64"}), and {"done": true,
  "elapsed_s", "timings"}; a failure after the headers is sent as an {"error"} line.
  `elapsed_s` is the seconds of the request's `request` span
  (`core.logging.timed_span`); `timings` holds its phases in seconds, each
  ended on the card (a synchronise): `mask_s` the mask stage with its
  hand-off, `stage2_s` the CT volume (streamed: to its last line),
  `first_slice_s` the request's start to its first CT slice done (streamed:
  sent), `encode_s` the blocking reads of the results off the card and their
  encoding (streamed: the slices', summed); a mask request has `mask_s` and
  `encode_s`.  With `trace_spans=1` (the recorder on, `core.logging`)
  `timings` also holds `spans`, {name: {count, issue_ms, card_ms}} of the
  request's spans.
GET /healthz -> {"status": "ok", "device": the torch device (with the card's name)}
404 for another path, 400 for an unknown kind, 500 {"error"} for a failure.

Every request draws from one `NoiseSource(seed, device)`, which
`request_noise` builds: the mask stage's draws, then stage 2's.  The config
keys are the JAX server's: a top-level `step_T_sample`, `stage1` (its
`dataset.volume_shape`, `checkpoint`, a DINO `feature_cond_encoder` whose
extractor is seeded from the section's `seed` + 11), `stage2` (a
`first_stage` serves the latent `_ae` route), `mask_steps`, `ddim_steps`,
`ddim_discretize`, `ddim_eta` and `volume_shape`; `fresh_init_noise` as in
`cli/sample.py`.
"""

from __future__ import annotations

import base64
import contextlib
import json
import sys
import tempfile
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..core.config import load_yaml_config
from ..core.logging import records, reset_spans, span_summary, span_table, timed_span, trace_spans
from ..core.runtime import configure_precision, resolve_device, synchronize
from ..data.nifti import write_nifti
from ..diffusion.noise import NoiseSource
from ..parallel.mesh import make_mesh_for_batch
from ..pipeline.two_stage import TwoStagePipeline, normalize_mask_channel, upsample_labels
from .common import build_dino_feature_fn, feature_cond
from .sample import _stage2, build_mask_sampler, load_mask_weights

__all__ = ["request_noise", "build_state", "make_handler", "device_name", "main"]


def request_noise(seed: int, device) -> NoiseSource:
    """The one source of a request's random draws."""
    return NoiseSource(seed, device)


def device_name(device: torch.device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _nifti_b64(vol: np.ndarray) -> str:
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "v.nii.gz"
        write_nifti(path, vol)
        return base64.b64encode(path.read_bytes()).decode()


def _batched_mesh(state: dict, bs: int):
    """The data mesh of a `batch: bs` request (None at 1), made once per
    batch size and cached in `state`."""
    if bs == 1:
        return None
    cache = state.setdefault("_mesh_cache", {})
    if bs not in cache:
        cache[bs] = make_mesh_for_batch(bs, device=state["device"])
    return cache[bs]


def build_state(cfg: dict, device=None) -> dict:
    """The models, weights and sampling settings a server answers from."""
    device = resolve_device(cfg.get("device", device))
    configure_precision()
    seed = int(cfg.get("seed", 1024))
    noise_std = float(cfg.get("fresh_init_noise", 0.0))
    s1 = cfg.get("stage1", cfg)
    if "step_T_sample" in cfg and "step_T_sample" not in s1:
        s1 = {**s1, "step_T_sample": cfg["step_T_sample"]}
    ms = build_mask_sampler(s1, device)
    load_mask_weights(ms, s1.get("checkpoint"), noise_std, seed + 1)
    spatial = tuple(s1.get("dataset", {}).get("volume_shape", (64, 128, 128)))
    feat_fn, feat_idx, _ = build_dino_feature_fn(s1, spatial, device)
    state = {"device": device, "ms": ms, "spatial": spatial, "mask_steps": int(cfg.get("mask_steps", 250)),
             "feat_fn": feat_fn, "feat_idx": feat_idx, "trace_spans": bool(int(cfg.get("trace_spans", 0)))}
    trace_spans(state["trace_spans"])
    if "stage2" in cfg:
        ldm, latent, ddim, _ = _stage2(cfg, cfg["stage2"], device, seed, noise_std)
        stage2 = latent if latent is not None else ldm
        state.update(ldm=stage2, pipe=TwoStagePipeline(ms, stage2), ddim=ddim,
                     volume_shape=tuple(cfg.get("volume_shape", (128, 256, 256))))
    return state


@contextlib.contextmanager
def _phase(timings: dict, key: str, device):
    """A `request.<phase>` span ended on the card; its seconds in `timings[key]`."""
    with timed_span(f"request.{key[:-2]}", True) as s:
        yield
        synchronize(device)
    timings[key] = round(s.seconds, 4)


def make_handler(state: dict):
    device = state["device"]

    def finish(timings: dict) -> dict:
        """`timings`, with the request's span table where the recorder is on."""
        if state["trace_spans"]:
            timings["spans"] = span_table(span_summary(records()))
            reset_spans()
        return timings

    def mask_stage(noise, bs: int, cond, fc, steps: int, timings: dict):
        """The mask program and its hand-off: (labels (B, D', H', W'), mask channel)."""
        with _phase(timings, "mask_s", device):
            labels = state["ms"].sample_labels(noise, (bs, *state["spatial"]), cond=cond, feature_cond=fc,
                                               num_steps=steps)
            labels_up = upsample_labels(labels, state["volume_shape"])
            return labels_up, normalize_mask_channel(labels_up, state["ms"].num_classes)

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def _line(self, obj: dict) -> None:
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()

        def _stream_two_stage(self, noise, bs: int, cond, fc, mask_steps: int, request, **sample_kw) -> None:
            """NDJSON: the headers only after the mask stage, so that from
            then on a failure is an error line, never a second status."""
            timings = {}
            labels_up, mask_channel = mask_stage(noise, bs, cond, fc, mask_steps, timings)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            try:
                self._line({"kind": "two_stage_stream", "n_slices": int(mask_channel.shape[1]), "batch": bs,
                            "labels_nifti_b64": _nifti_b64(labels_up[0].cpu().numpy().astype(np.uint8))})
                encode = 0.0
                with _phase(timings, "stage2_s", device):
                    for z, s in enumerate(state["ldm"].stream_volume(noise, mask_channel, state["ddim"],
                                                                     **sample_kw)):
                        t = time.perf_counter()
                        arr = s.float().cpu().numpy().astype(np.float16)  # (B, H, W, C)
                        line = {"slice": z, "shape": list(arr.shape), "dtype": "float16",
                                "data_b64": base64.b64encode(arr.tobytes()).decode()}
                        encode += time.perf_counter() - t
                        self._line(line)
                        if z == 0:
                            timings["first_slice_s"] = round(request.seconds, 4)
                timings["encode_s"] = round(encode, 4)
                self._line({"done": True, "elapsed_s": round(request.seconds, 2), "timings": finish(timings)})
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away
            except Exception as e:
                try:
                    self._line({"error": str(e)})
                except OSError:
                    pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "device": device_name(device)})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                kind = req.get("kind", "mask")
                if kind not in ("mask", "two_stage"):
                    self._json(400, {"error": f"unknown kind {kind!r}"})
                    return
                with timed_span("request") as request:
                    self._generate(req, kind, request)
            except Exception as e:  # the client hears of every failure
                self._json(500, {"error": str(e)})

        def _generate(self, req: dict, kind: str, request) -> None:
            noise = request_noise(int(req.get("seed", 0)), device)
            bs = max(1, int(req.get("batch", 1)))
            steps = int(req.get("mask_steps", state["mask_steps"]))
            mesh = _batched_mesh(state, bs)
            for model in (state["ms"], state.get("ldm")):
                if model is not None:
                    model.unet.set_mesh(mesh)
            with torch.inference_mode():
                cond = torch.zeros((bs, *state["spatial"], 1), device=device)
                fc = feature_cond(state["feat_fn"], state["feat_idx"], cond)
                if kind == "mask":
                    self._json(200, self._mask(noise, bs, cond, fc, steps, request))
                    return
                if "pipe" not in state:
                    raise ValueError("two_stage needs a `stage2` section in the server's config")
                ws = req.get("warm_start")
                sample_kw = {"guidance_scale": float(req.get("guidance_scale", 1.0)),
                             "warm_start": None if ws is None else float(ws),
                             "sampler": str(req.get("sampler", "ddim"))}
                if req.get("stream"):
                    self._stream_two_stage(noise, bs, cond, fc, steps, request, **sample_kw)
                    return
                self._json(200, self._two_stage(noise, bs, cond, fc, steps, request, sample_kw))

        def _mask(self, noise, bs: int, cond, fc, steps: int, request) -> dict:
            timings = {}
            with _phase(timings, "mask_s", device):
                labels = state["ms"].sample_labels(noise, (bs, *state["spatial"]), cond=cond, feature_cond=fc,
                                                   num_steps=steps)
            with _phase(timings, "encode_s", device):
                batch_labels = labels.cpu().numpy()
                resp = {"labels_nifti_b64": _nifti_b64(batch_labels[0].astype(np.uint8)),
                        "class_counts": {int(c): int(k) for c, k in zip(*np.unique(batch_labels[0],
                                                                                     return_counts=True))}}
                if bs > 1:
                    resp["batch_labels_nifti_b64"] = [_nifti_b64(v.astype(np.uint8)) for v in batch_labels]
            resp.update(elapsed_s=round(request.seconds, 2), timings=finish(timings))
            return resp

        def _two_stage(self, noise, bs: int, cond, fc, steps: int, request, sample_kw: dict) -> dict:
            """The two-stage pipeline (`TwoStagePipeline`'s stages, in its
            order and with its draws), phase by phase."""
            timings = {}
            labels, mask_channel = mask_stage(noise, bs, cond, fc, steps, timings)
            with _phase(timings, "stage2_s", device):
                slices = []
                for s in state["ldm"].stream_volume(noise, mask_channel, state["ddim"], **sample_kw):
                    if not slices:
                        synchronize(device)
                        timings["first_slice_s"] = round(request.seconds, 4)
                    slices.append(s)
                ct = torch.stack(slices, dim=1)
            with _phase(timings, "encode_s", device):
                ct, labels = ct.float().cpu().numpy(), labels.cpu().numpy()
                resp = {"ct_nifti_b64": _nifti_b64(ct[0, ..., 0]),
                        "labels_nifti_b64": _nifti_b64(labels[0].astype(np.uint8))}
                if bs > 1:
                    resp["batch_ct_nifti_b64"] = [_nifti_b64(v[..., 0]) for v in ct]
                    resp["batch_labels_nifti_b64"] = [_nifti_b64(v.astype(np.uint8)) for v in labels]
            resp.update(elapsed_s=round(request.seconds, 2), timings=finish(timings))
            return resp

    return Handler


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit(__doc__)
    port = next((int(a) for a in argv[1:] if a.isdigit()), 8787)
    cfg = load_yaml_config(argv[0], overrides=[a for a in argv[1:] if "=" in a])
    state = build_state(cfg)
    server = HTTPServer(("0.0.0.0", port), make_handler(state))
    print(f"serving on :{port} (device {device_name(state['device'])})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
