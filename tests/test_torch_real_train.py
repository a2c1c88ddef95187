"""PyTorch port: both trainers on a tiny NIfTI index, on the CPU.

Stage 1 on `ruijin` (with and without the text refiner over the index's
features) and `ruijin_3d`, stage 2 on `ruijin` and `nnunet`: one step each,
a finite loss, a checkpoint, and a validation that reads the 'val' split
only (the JAX trainers validate on `build_*_dataset(cfg, "val")`), while the
loader reads the 'train' split only.  The dataset kinds the port does not
have raise as the JAX CLI's do.
"""

import json

import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli import common as tcommon
from jointimagegeneration_torch.cli import train_ldm, train_mask
from jointimagegeneration_torch.core.checkpoint import CheckpointManager
from jointimagegeneration_torch.data import datasets as tds

from test_torch_data import write_cases

UNET1 = {"base_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2], "num_res_blocks": 1,
         "num_head_channels": 4}
UNET2 = {"model_channels": 8, "channel_mult": [1, 2], "attention_resolutions": [2], "num_res_blocks": 1,
         "num_head_channels": 4}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the same
    cores, where spinning thread pools slow each other down many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return write_cases(tmp_path_factory.mktemp("cases"))


class _Spy:
    """A dataset that records the cases read from it, by split."""

    def __init__(self, ds, split: str, log: list):
        self.ds, self.split, self.log = ds, split, log

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = self.ds[i]
        self.log.append((self.split, item["casename"]))
        return item

    def __getattr__(self, name):
        return getattr(self.ds, name)


def _spy(monkeypatch, module, name: str) -> list:
    log, build = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda cfg, split="train": _Spy(build(cfg, split), split, log))
    return log


def _splits(index: str):
    keys = json.loads(open(index).read())
    return tds.train_val_split(list(keys))


def _stage1_cfg(out, dataset, **kw):
    cfg = {"output_path": str(out), "seed": 0, "num_classes": 12, "time_steps": 20, "bf16": False, "batch_size": 1,
           "max_steps": 1, "save_freq": 1, "display_freq": 1, "validation_freq_steps": 1, "eval_time_steps": 2,
           "n_validation_images": 2, "device": "cpu", "optim": {"name": "AdamW", "learning_rate": 1e-3},
           "unet_openai": UNET1, "dataset": dataset}
    cfg.update(kw)
    return cfg


def _check_run(logdir, val_key: str):
    recs = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "train/loss" in r]
    assert [r["step"] for r in train] == [1] and np.isfinite(train[0]["train/loss"])
    assert train[0]["train/grad_finite"] == 1.0 and train[0]["train/data_seconds"] >= 0.0
    assert CheckpointManager(logdir / "checkpoints").all_steps()["rolling"] == [1]
    return [r for r in recs if val_key in r]


STAGE1 = {
    "ruijin": ({"kind": "ruijin", "volume_shape": [4, 8, 8]}, {}),
    "ruijin_3d": ({"kind": "ruijin_3d", "volume_shape": [4, 8, 8]}, {}),
    "ruijin_text": ({"kind": "ruijin", "volume_shape": [4, 8, 8]},
                    {"feature_cond_encoder": {"type": "selfattn", "embed_dim": 16, "n_heads": 2, "d_head": 8,
                                              "model_depth": 1}}),
}


@pytest.mark.parametrize("kind", list(STAGE1))
def test_stage1_trains_on_an_index_and_validates_on_val(tmp_path, cases, monkeypatch, kind):
    dataset, extra = STAGE1[kind]
    log = _spy(monkeypatch, train_mask, "build_mask_dataset")
    cfg = _stage1_cfg(tmp_path / "runs", {**dataset, "index": cases["index"]}, **extra)
    state = train_mask.run(cfg, "e")
    val = _check_run(tmp_path / "runs" / "e", "val/dice")
    assert len(val) == 1 and 0.0 <= val[0]["val/dice"] <= 1.0
    train_keys, val_keys = _splits(cases["index"])
    assert {k for s, k in log if s == "train"} <= set(train_keys) and {s for s, _ in log} == {"train", "val"}
    assert [k for s, k in log if s == "val"] == val_keys  # min(1 val case, n_validation_images 2)
    refiner = [n for n in state.names if n.startswith("refiner.")]
    assert bool(refiner) == ("feature_cond_encoder" in extra)


@pytest.mark.parametrize("kind", ["ruijin", "nnunet"])
def test_stage2_trains_on_real_data_and_validates_on_val(tmp_path, cases, monkeypatch, kind):
    log = _spy(monkeypatch, train_ldm, "build_slice_dataset")
    dataset = ({"kind": "ruijin", "index": cases["index"]} if kind == "ruijin"
               else {"kind": "nnunet", "root": cases["nnunet"]})
    cfg = {"output_path": str(tmp_path / "runs"), "seed": 0, "batch_size": 1, "max_steps": 1, "save_freq": 1,
           "display_freq": 1, "eval_every": 1, "n_log_images": 2, "log_ddim_steps": 2, "device": "cpu",
           "model": {"timesteps": 20, "bf16": False, "learn_logvar": True, "unet_config": {"params": UNET2}},
           "dataset": {**dataset, "slice_shape": [16, 16]}}
    train_ldm.run(cfg, "e")
    val = _check_run(tmp_path / "runs" / "e", "val/loss_simple")
    assert len(val) == 1 and np.isfinite(val[0]["val/loss_simple"])
    train_keys, val_keys = _splits(cases["index"])
    assert {k for s, k in log if s == "train"} <= set(train_keys)
    assert sorted({k for s, k in log if s == "val"}) == val_keys


def test_dataset_kinds(cases, tmp_path):
    """The kinds of the JAX CLI: the real ones build, the stock ones (ported
    since; tests/test_torch_stock_data.py holds their items) build their
    datasets over a one-image tree, an unknown one raises ValueError."""
    assert isinstance(tcommon.build_mask_dataset({"dataset": {"kind": "ruijin", "index": cases["index"]}}, "val"),
                      tds.RuijinMaskDataset)
    assert isinstance(tcommon.build_mask_dataset({"dataset": {"kind": "ruijin_3d", "index": cases["index"]}}),
                      tds.RuijinVolumeDataset)
    assert isinstance(tcommon.build_slice_dataset({"dataset": {"kind": "nnunet", "root": cases["nnunet"]}}, "val"),
                      tds.NNUNetLayoutDataset)
    from PIL import Image

    from jointimagegeneration_torch.data import stock

    (tmp_path / "n01440764").mkdir()
    Image.fromarray(np.zeros((40, 36, 3), np.uint8)).save(tmp_path / "n01440764" / "a.JPEG")
    (tmp_path / "list.txt").write_text("n01440764/a.JPEG\n")
    for d, cls in (({"kind": "lsun", "txt_file": str(tmp_path / "list.txt"), "data_root": str(tmp_path)},
                    stock.LSUNBase),
                   ({"kind": "imagenet", "root": str(tmp_path)}, stock.ImageNetLocal),
                   ({"kind": "imagenet_sr", "root": str(tmp_path), "size": 16}, stock.SRToLDMAdapter)):
        ds = tcommon.build_slice_dataset({"dataset": {**d, "slice_shape": [16, 16]}}, "train")
        assert isinstance(ds, cls) and len(ds) == 1 and ds[0]["image"].shape == (16, 16, 3)
    for build in (tcommon.build_slice_dataset, tcommon.build_mask_dataset):
        with pytest.raises(ValueError, match="unknown dataset kind"):
            build({"dataset": {"kind": "nope"}}, "train")
