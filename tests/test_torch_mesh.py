"""PyTorch port: data parallelism over torch.distributed (`parallel/mesh.py`).

Two gloo ranks on the CPU (`torch.multiprocessing`, the launcher's
environment on a free localhost port), one spawn for the module:
  * a 2-rank step of stage 1 and of pixel stage 2, each rank on its row of a
    global batch of 2 with the global batch's draws cut to its row, equals
    the one-process step on both rows: every parameter and EMA tensor within
    1e-5 of that tensor's max |value| (the gradients of one row and of two
    sum in another order; the worst, 6.2e-6, is a zero-initialised GroupNorm
    bias, all of whose value is its one step), and bit for bit the same on
    both ranks.  The UNets are 64 wide, so that GroupNorm's 32 groups hold
    two channels: at 8 channels each group holds one, which cancels every
    per-channel shift (the time embedding's, the biases in front of a norm),
    and those gradients are rounding noise.  The step is
    SGD's: Adam's first step divides each gradient by its own size, which
    turns the rounding noise of a gradient that GroupNorm cancels (a bias in
    front of one, ~1e-7 where others are ~1) into a step of +-lr;
  * `cli.train_mask` on 2 ranks: only rank 0 writes metrics, checkpoints and
    the run config, the ranks end with the same parameters, the logged loss
    is the mean of the ranks' own losses (the global batch's, as the JAX
    step's), and a global batch the ranks do not divide raises ValueError
    before any step;
then, in this process: no launcher environment, no process group; and the
loader's per-rank shards of the epoch permutation against the JAX loader's
`_epoch_indices` for 1, 2 and 3 processes.

The single-controller mesh (the counterparts of `tests/test_sharding.py`'s
fast cases), on eight stand-in cards (`torch.device("cuda", i)` names no
card until a tensor is put there): the mesh shapes, `make_mesh_for_batch`
at batch sizes 2, 3, 6, 8 and 16 and at model = 2, every device once, the
errors; `replicate` and `shard_batch`; then `cli.sample`'s batched `stage:
mask` over a data axis of two CPU devices, equal to one device."""

import os
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jointimagegeneration_torch.diffusion.noise import NoiseSource
from jointimagegeneration_torch.parallel import mesh
from jointimagegeneration_torch.train.optim import build_optimizer
from jointimagegeneration_torch.train.state import EMATrainState
from jointimagegeneration_torch.train.steps import make_ldm_train_step, make_mask_train_step

WORLD = 2
LR = 1e-2
PARAM_TOL = 1e-5
UNET1 = {"base_channels": 64, "channel_mult": [1, 2], "attention_resolutions": [1], "num_res_blocks": 1,
         "num_head_channels": 4}
UNET2 = {"model_channels": 64, "channel_mult": [1, 2], "attention_resolutions": [1], "num_res_blocks": 1,
         "num_head_channels": 4}


def _stage(kind: str):
    """(model, train state, step fn, global batch of 2) for `kind`."""
    from jointimagegeneration_torch.cli.common import fill_zero_init
    from jointimagegeneration_torch.cli.sample import build_mask_sampler, build_slice_ldm

    rs = np.random.RandomState(7)
    if kind == "stage1":
        model = build_mask_sampler({"num_classes": 4, "time_steps": 20, "bf16": False, "unet_openai": UNET1}, "cpu",
                                   cond_channels=1, seed=0)
        labels = rs.randint(0, 4, (2, 8, 8, 8))
        batch = {"mask": np.eye(4, dtype=np.float32)[labels], "image": rs.rand(2, 8, 8, 8, 1).astype(np.float32)}
        step = make_mask_train_step(model)
    else:
        model = build_slice_ldm({"timesteps": 100, "bf16": False, "unet_config": {"params": UNET2}}, "cpu",
                                seed=0, learn_logvar=True)
        batch = {"image": rs.rand(2, 16, 16, 1).astype(np.float32), "cond": rs.rand(2, 16, 16, 2).astype(np.float32)}
        step = make_ldm_train_step(model)
    fill_zero_init(model.unet, 0.05, 1)  # every layer gets a gradient
    state = EMATrainState(build_optimizer(model.named_parameters(), "SGD", LR), ema_decay=0.9)
    return state, step, batch


def _after_step(kind: str, rows: slice, noise) -> dict:
    state, step, batch = _stage(kind)
    step(state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()}, noise)
    sd = state.state_dict()
    return {part: {k: v.clone() for k, v in sd[part].items()} for part in ("params", "ema")}


def _cli_cfg(out, **kw):
    cfg = {"output_path": str(out), "seed": 0, "num_classes": 4, "time_steps": 20, "bf16": False, "batch_size": 2,
           "max_steps": 2, "save_freq": 2, "display_freq": 1, "validation_freq_steps": 2, "eval_time_steps": 2,
           "n_validation_images": 1, "device": "cpu", "mp_loaders": 1, "unet_openai": UNET1,
           "dataset": {"kind": "synthetic", "volume_shape": [8, 8, 8], "num_cases": 4}}
    cfg.update(kw)
    return cfg


def _worker(rank: int, port: int, out: str) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from jointimagegeneration_torch.cli import train_mask
    from jointimagegeneration_torch.train import trainer

    out = Path(out)
    assert mesh.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert (mesh.world_size(), mesh.rank(), mesh.is_chief()) == (WORLD, rank, rank == 0)
    try:
        res = {}
        for kind in ("stage1", "stage2"):
            noise = mesh.rank_rows(NoiseSource(11, "cpu"))
            res[kind] = _after_step(kind, slice(rank, rank + 1), noise)
        seen, mean = [], trainer.mean_over_ranks

        def recording(metrics, device):  # (this rank's loss, the logged one) per logged step
            logged = mean(metrics, device)
            seen.append((float(metrics["loss"]), logged["loss"]))
            return logged

        trainer.mean_over_ranks = recording
        state = train_mask.run(_cli_cfg(out / f"rank{rank}"), "e1")
        trainer.mean_over_ranks = mean
        res["cli"] = {k: v.clone() for k, v in state.state_dict()["params"].items()}
        res["losses"] = torch.tensor(seen, dtype=torch.float64)
        try:
            train_mask.run(_cli_cfg(out / f"odd{rank}", batch_size=3), "e1")
            res["indivisible"] = "no error"
        except ValueError as e:
            res["indivisible"] = str(e)
        torch.save(res, out / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.spawn(_worker, args=(port, str(out)), nprocs=WORLD, join=False)
    deadline = time.monotonic() + 300
    try:
        while not ctx.join(timeout=5):  # raises if a rank failed
            assert time.monotonic() < deadline, "the ranks did not finish within 300 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    assert not any(p.is_alive() for p in ctx.processes)
    return out, [torch.load(out / f"result{r}.pt", weights_only=True) for r in range(WORLD)]


@pytest.mark.parametrize("kind", ["stage1", "stage2"])
def test_two_rank_step_equals_one_process_step(ranks, kind):
    _, res = ranks
    one = _after_step(kind, slice(0, 2), NoiseSource(11, "cpu"))
    init = _stage(kind)[0].state_dict()["params"]
    worst = 0.0
    for part in ("params", "ema"):
        for name, want in one[part].items():
            step = want - init[name]
            assert float(step.abs().max()) > 0, (part, name)  # every tensor moved
            for r in range(WORLD):
                got = res[r][kind][part][name]
                assert torch.equal(got, res[0][kind][part][name]), (part, name, r)
                rel = float((got - want).abs().max()) / float(want.abs().max())
                worst = max(worst, rel)
                assert rel <= PARAM_TOL, (part, name, rel)
    print(f"{kind}: worst difference {worst:.2e} of the tensor's max")


def test_only_the_chief_writes(ranks):
    out, res = ranks
    logdir = out / "rank0" / "e1"
    assert (logdir / "metrics.jsonl").stat().st_size > 0
    assert (logdir / "checkpoints" / "2.pt").exists() and (logdir / "configs" / "run-config.json").exists()
    assert not (out / "rank1").exists()
    for name, p in res[0]["cli"].items():
        assert torch.equal(p, res[1]["cli"][name]), name


def test_logged_loss_is_the_global_batch_mean(ranks):
    import json

    out, res = ranks
    local = torch.stack([res[r]["losses"][:, 0] for r in range(WORLD)])
    logged = res[0]["losses"][:, 1]
    assert logged.shape == (2,)  # display_freq 1, 2 steps
    for r in range(WORLD):
        assert torch.equal(res[r]["losses"][:, 1], logged), r
    torch.testing.assert_close(logged, local.mean(0), rtol=1e-6, atol=0)
    assert not torch.allclose(logged, local[0], rtol=1e-4, atol=0)  # rank 0's rows alone give another loss
    recs = [json.loads(line) for line in (out / "rank0" / "e1" / "metrics.jsonl").read_text().splitlines()]
    assert [r["train/loss"] for r in recs if "train/loss" in r] == logged.tolist()


def test_indivisible_global_batch_raises(ranks):
    _, res = ranks
    for r in range(WORLD):
        assert "batch_size 3 (the global batch) is not divisible by the 2 ranks" in res[r]["indivisible"]
    assert not (ranks[0] / "odd0").exists()  # raised before the trainer wrote anything


def test_no_launcher_environment_no_process_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (mesh.world_size(), mesh.rank(), mesh.is_chief(), mesh.local_batch_size(3)) == (1, 0, True, 3)
    noise = NoiseSource(0, "cpu")
    assert mesh.rank_rows(noise) is noise
    grads = [torch.ones(3)]
    mesh.average_gradients(grads)
    assert torch.equal(grads[0], torch.ones(3))


@pytest.mark.parametrize("procs", [1, 2, 3])
def test_loader_shards_match_jax(monkeypatch, procs):
    import jax

    from jointimagegeneration_torch.data.loader import DataLoader
    from jointimagegeneration_tpu.data.loader import DataLoader as JLoader

    ds = list(range(23))
    for r in range(procs):
        monkeypatch.setattr(jax, "process_count", lambda: procs)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(mesh, "world_size", lambda: procs)
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        jl = JLoader(ds, batch_size=2, seed=5, num_workers=1)
        tl = DataLoader(ds, batch_size=2, seed=5, num_workers=1)
        for epoch in (0, 3):
            jl.epoch = tl.epoch = epoch
            np.testing.assert_array_equal(tl._epoch_indices(), jl._epoch_indices())
        assert len(tl) == len(jl) == (23 // procs) // 2
    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    monkeypatch.setattr(mesh, "rank", lambda: 0)
    with pytest.raises(ValueError, match="dataset shard"):
        DataLoader(list(range(5)), batch_size=2)


CARDS = [torch.device("cuda", i) for i in range(8)]


@pytest.fixture
def eight_cards(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(mesh, "local_devices", lambda device=None: list(CARDS))


def test_make_mesh_shapes(eight_cards, monkeypatch):
    assert mesh.make_mesh().shape == {"data": 8, "model": 1}
    m = mesh.make_mesh(data=4, model=2)
    assert m.shape == {"data": 4, "model": 2}
    assert m.devices[1] == CARDS[2:4]
    assert mesh.make_mesh(model=4, devices=["cpu"] * 4).devices == [[torch.device("cpu")] * 4]  # a device may repeat
    for bad in ({"data": 4, "model": 4}, {"model": 3}, {"data": 3}, {"model": 0}):
        with pytest.raises(ValueError, match="mesh"):
            mesh.make_mesh(**bad)
    monkeypatch.setenv("LOCAL_RANK", "2")  # under torchrun: this rank's 'model' cards
    assert mesh.make_mesh(model=2).devices == [CARDS[4:6]]


@pytest.mark.parametrize("batch,model,used", [(2, 1, 2), (3, 1, 3), (6, 1, 6), (8, 1, 8), (16, 1, 8), (4, 2, 8)])
def test_make_mesh_for_batch_uses_a_compatible_subset(eight_cards, batch, model, used):
    m = mesh.make_mesh_for_batch(batch, model=model)
    assert m.shape == {"data": used // model, "model": model}
    assert batch % m.shape["data"] == 0
    assert [d for row in m.devices for d in row] == CARDS[:used]


def test_make_mesh_covers_every_device_once(eight_cards):
    m = mesh.make_mesh(data=4, model=2)
    flat = [d for row in m.devices for d in row]
    assert sorted(flat, key=lambda d: d.index) == CARDS and m.distinct() == CARDS


def test_replicate_and_shard_batch():
    net = torch.nn.Linear(2, 3)
    m = mesh.make_mesh(data=2, devices=["cpu"] * 2)
    assert mesh.replicate(m, net) == {torch.device("cpu"): net}  # a repeated device shares the module
    rows = mesh.shard_batch(m, torch.arange(6.0).reshape(3, 2))
    assert [r.tolist() for r in rows] == [[[0.0, 1.0], [2.0, 3.0]], [[4.0, 5.0]]]


@pytest.fixture
def one_torch_thread():
    """One torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_batched_mask_over_two_devices_equals_one(tmp_path, monkeypatch, one_torch_thread):
    """`stage: mask` at batch_size 2 over a data axis of two CPU devices:
    each UNet call runs its rows apart, the draws stay the whole batch's, and
    the labels are those of one device, bit for bit."""
    from jointimagegeneration_torch.cli import sample

    s1 = {"num_classes": 4, "time_steps": 20, "bf16": False,
          "unet_openai": {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2],
                          "num_res_blocks": 1, "num_head_channels": 4},
          "dataset": {"kind": "synthetic", "volume_shape": [4, 8, 8], "num_cases": 4, "seed": 1}}
    cfg = {"stage": "mask", "device": "cpu", "seed": 3, "n_cases": 3, "batch_size": 2, "samples": 2, "mask_steps": 3,
           "fresh_init_noise": 0.05, "stage1": s1}
    one = sample.run({**cfg, "output_path": str(tmp_path / "one")})
    meshes, make = [], sample.make_mesh_for_batch
    monkeypatch.setattr(mesh, "local_devices", lambda device=None: [torch.device("cpu")] * 2)
    monkeypatch.setattr(sample, "make_mesh_for_batch", lambda *a, **kw: meshes.append(make(*a, **kw)) or meshes[-1])
    two = sample.run({**cfg, "output_path": str(tmp_path / "two")})
    assert [m.shape for m in meshes] == [{"data": 2, "model": 1}]
    assert len(np.unique(one["labels"])) > 1
    np.testing.assert_array_equal(two["labels"], one["labels"])
