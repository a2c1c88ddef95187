"""PyTorch port: the trainer's extras (`profile_steps`, TensorBoard, the code
archive, SIGUSR2) and `utils/misc.py` against the JAX package, on the CPU.

The profiler window is the JAX trainer's rule (train/trainer.py:137-139
there): N steps from the third step after the start, or from the first when
no more than N + 3 steps are left; the port writes a chrome trace
`<logdir>/profile/trace_step<last traced step>.json` and prints its summary
(on the CPU the top-level host ops, as no device kernel runs).  `count_params`
and `convert_legacy_resblock_params` equal the JAX functions' results
exactly.
"""

import json
import signal
import sys
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jointimagegeneration_torch.core.logging import MetricLogger, summarize_trace
from jointimagegeneration_torch.nn.unet import UNet as TUNet
from jointimagegeneration_torch.train.optim import build_optimizer
from jointimagegeneration_torch.train.state import EMATrainState
from jointimagegeneration_torch.train.trainer import Trainer, TrainerConfig
from jointimagegeneration_torch.utils import misc as tmisc
from jointimagegeneration_torch.utils.jax_weights import unet_state_dict_from_jax
from jointimagegeneration_tpu.nn.unet import UNet
from jointimagegeneration_tpu.utils import misc as jmisc

from test_torch_weights import init_flax


def _jax_window(step: int, max_steps: int, n: int) -> int:
    """The JAX trainer's start step (trainer.py:137-139)."""
    return step + 3 if max_steps - step > n + 3 else step + 1


class _Run:
    """A Trainer over a one-parameter least-squares problem."""

    def __init__(self, logdir, max_steps: int, profile_steps: int = 0, seen=None):
        self.w = torch.nn.Parameter(torch.zeros(4))
        self.state = EMATrainState(build_optimizer([("w", self.w)], "SGD", 0.1), ema_decay=0.5)
        self.seen = seen

        def step(state, batch, noise):
            if self.seen is not None:
                self.seen.append(signal.getsignal(signal.SIGUSR2))
            loss = ((self.w - batch["x"].mean(0)) ** 2).sum()
            (g,) = torch.autograd.grad(loss, [self.w])
            state.apply_gradients({"w": g})
            return {"loss": loss.detach()}

        batches = [{"x": torch.full((2, 4), float(i))} for i in range(max_steps)]
        self.trainer = Trainer(TrainerConfig(logdir=str(logdir), max_steps=max_steps, log_every=1, save_every=10**6,
                                             eval_every=10**6, profile_steps=profile_steps),
                               self.state, step, batches, torch.device("cpu"))


@pytest.mark.parametrize("max_steps,n", [(8, 2), (4, 1), (3, 2)])
def test_profile_steps_window_and_summary(tmp_path, capsys, max_steps, n):
    _Run(tmp_path, max_steps, n).trainer.fit()
    start = _jax_window(0, max_steps, n)
    traces = list((tmp_path / "profile").glob("trace_step*.json"))
    assert [t.name for t in traces] == [f"trace_step{start + n - 1}.json"]
    out = capsys.readouterr().out
    assert f"profiler: {n}-step trace" in out and "cpu:" in out
    rows = summarize_trace(tmp_path / "profile")
    assert rows and all(k.startswith("cpu:") and ms >= 0 and c >= 1 for k, ms, c in rows)
    # the window holds `n` train steps: each runs the optimizer once
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "Optimizer.step#SGD.step" for e in events) == n


def test_no_profile_without_profile_steps(tmp_path):
    _Run(tmp_path, 3).trainer.fit()
    assert not (tmp_path / "profile").exists()


def test_tensorboard_events_where_tensorboardx_imports(tmp_path, monkeypatch):
    pytest.importorskip("tensorboardX")
    _Run(tmp_path / "tb", 2).trainer.fit()
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    logger = MetricLogger(tmp_path / "img")
    assert logger._tb is not None
    logger.image(1, "val/x", np.zeros((4, 4, 3), np.uint8))
    logger.close()
    # neither writer importable: no events, the JSONL as always, no failure
    for m in ("tensorboardX", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, m, None)
    logger = MetricLogger(tmp_path / "none", wandb_project="p")  # no wandb here: no mirror, no failure
    assert logger._tb is None and logger._wandb is None
    logger.scalars(1, {"loss": 2.0}, "train/")
    logger.close()
    assert not list((tmp_path / "none").glob("events.out.tfevents.*"))
    assert (tmp_path / "none" / "metrics.jsonl").read_text().strip() == '{"step": 1, "train/loss": 2.0}'


def test_archive_code_holds_the_port(tmp_path):
    _Run(tmp_path / "run", 1).trainer.fit()
    with tarfile.open(tmp_path / "run" / "code.tar.gz") as tar:
        names = set(tar.getnames())
    assert {"jointimagegeneration_torch/train/trainer.py", "jointimagegeneration_torch/nn/unet.py"} <= names
    # without git (a checkout of files alone) every *.py under the root
    root = tmp_path / "repo"
    (root / "pkg").mkdir(parents=True)
    (root / "pkg" / "a.py").write_text("x = 1\n")
    (root / "notes.txt").write_text("x")
    out = tmisc.archive_code(tmp_path / "out", repo_root=root)
    with tarfile.open(out) as tar:
        assert tar.getnames() == ["pkg/a.py"]


def test_sigusr2_installed_during_fit_and_restored(tmp_path):
    seen = []
    previous = signal.getsignal(signal.SIGUSR2)
    run = _Run(tmp_path, 2, seen=seen)
    run.trainer.fit()
    assert seen == [run.trainer._divein] * 2
    assert signal.getsignal(signal.SIGUSR2) == previous


def test_count_params_matches_jax():
    kw = dict(model_channels=8, out_channels=2, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              dims=2, num_head_channels=4)
    p = init_flax(UNet(**kw), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)))
    n = jmisc.count_params(p)
    assert tmisc.count_params(p) == n
    assert tmisc.count_params(TUNet(in_channels=3, device="cpu", **kw)) == n
    assert tmisc.count_params(unet_state_dict_from_jax(p).values()) == n


def _legacy(tree):
    """The flat ResBlock layout back into the round-1 nested one."""
    if not isinstance(tree, dict):
        return tree
    if "conv1_kernel" in tree:
        out = {k: v for k, v in tree.items() if not k.startswith(("norm1_", "conv1_", "emb_", "norm2_", "conv2_",
                                                                 "skip_"))}
        out.update(in_norm={"GroupNorm_0": {"scale": tree["norm1_scale"], "bias": tree["norm1_bias"]}},
                   in_conv={"kernel": tree["conv1_kernel"], "bias": tree["conv1_bias"]},
                   emb_proj={"kernel": tree["emb_kernel"], "bias": tree["emb_bias"]},
                   out_norm={"GroupNorm_0": {"scale": tree["norm2_scale"], "bias": tree["norm2_bias"]}},
                   out_conv={"kernel": tree["conv2_kernel"], "bias": tree["conv2_bias"]})
        if "skip_kernel" in tree:
            out["skip"] = {"kernel": tree["skip_kernel"], "bias": tree["skip_bias"]}
        return out
    return {k: _legacy(v) for k, v in tree.items()}


def _equal_trees(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_convert_legacy_resblock_params_matches_jax_and_loads(tmp_path):
    kw = dict(model_channels=8, out_channels=2, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
              dims=2, num_head_channels=4)
    p = init_flax(UNet(**kw), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)))
    p = jax_to_dict(p)
    legacy = {"params": _legacy(p)}
    assert "emb_proj" in legacy["params"]["down_1_0_res"]
    _equal_trees(tmisc.convert_legacy_resblock_params(legacy), jax_to_dict(jmisc.convert_legacy_resblock_params(legacy)))
    _equal_trees(tmisc.convert_legacy_resblock_params(legacy), {"params": p})
    # the bridge reads a round-1 .npz tree into the port's UNet
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            walk(v, prefix + [k]) if isinstance(v, dict) else flat.__setitem__("/".join(prefix + [k]), np.asarray(v))

    walk(legacy, [])
    np.savez(tmp_path / "legacy.npz", **flat)
    got, want = unet_state_dict_from_jax(str(tmp_path / "legacy.npz")), unet_state_dict_from_jax(p)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    TUNet(in_channels=3, device="cpu", **kw).load_state_dict(got)


def jax_to_dict(tree):
    return {k: jax_to_dict(v) for k, v in tree.items()} if hasattr(tree, "items") else np.asarray(tree)


def test_set_host_seeds():
    tmisc.set_host_seeds(7)
    a = (np.random.rand(), torch.rand(1).item())
    tmisc.set_host_seeds(7)
    assert a == (np.random.rand(), torch.rand(1).item())
