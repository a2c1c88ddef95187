"""PyTorch port: `init_from` warm-start surgery (`core.checkpoint.load_partial`,
`cli.common.maybe_init_from`) against the JAX package's `load_partial` on the
same trees, and through the three trainers' CLIs, on the CPU.

Every case of the JAX `tests/test_checkpoint_surgery.py` runs here twice: the
JAX function on its orbax checkpoint, and the port's on the same tree as a JAX
`.npz` and as a port `.pt` checkpoint (the same weights under the port's
names: `params`, `ema`, `g_params`).  The results are equal bit for bit after
the weight bridge (a copy moves no value).  An ignore key is written as the
file's own paths: JAX paths for the `.npz` ('unet/params/out'), port names for
the `.pt` ('unet.out', dotted, or 'out').
"""

import numpy as np
import pytest
import torch

from jointimagegeneration_torch.cli.common import maybe_init_from
from jointimagegeneration_torch.core.checkpoint import CheckpointManager as TManager, load_partial as t_load_partial
from jointimagegeneration_torch.utils.jax_weights import ae_state_dict_from_jax, unet_state_dict_from_jax
from jointimagegeneration_tpu.core.checkpoint import CheckpointManager, load_partial


def _tree(scale: float, head=4):
    return {  # the JAX test's wrapped {'unet', 'refiner'} layout
        "unet": {"params": {"in": {"kernel": np.full((3, 3), scale, np.float32)},
                            "out": {"kernel": np.full((head,), scale * 2, np.float32)}}},
        "refiner": {"params": {"w": np.full((2, 2), scale * 3, np.float32)}},
    }


def _flat_npz(path, tree: dict) -> str:
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(tree, ())
    np.savez(path, **flat)
    return str(path)


@pytest.fixture()
def ckpts(tmp_path):
    """The JAX orbax checkpoint, the same tree as an .npz, and as a port .pt."""
    saved = {"params": _tree(1.0), "ema_params": _tree(10.0), "opt_state": {"count": np.zeros((), np.int32)},
             "step": np.int32(7)}
    mgr = CheckpointManager(tmp_path / "jax")
    mgr.save(7, saved)
    mgr.wait()
    npz = _flat_npz(tmp_path / "ck.npz", {"params": _tree(1.0), "ema_params": _tree(10.0)})
    TManager(tmp_path / "port").save(7, {"params": unet_state_dict_from_jax(_tree(1.0)),
                                         "ema": unet_state_dict_from_jax(_tree(10.0)), "step": 7})
    return tmp_path / "jax", {"npz": npz, "pt": str(tmp_path / "port")}


def _template(tree) -> dict:
    return unet_state_dict_from_jax(tree)


def _same(port: dict, jax_tree, bridge=unet_state_dict_from_jax):
    want = bridge(jax_tree)
    assert sorted(port) == sorted(want)
    for k, v in want.items():
        assert torch.equal(port[k], v), k


FORMATS = ["npz", "pt"]
OUT_KEY = {"npz": "unet/params/out", "pt": "unet.out"}


@pytest.mark.parametrize("fmt", FORMATS)
def test_full_surgery_load(ckpts, fmt):
    jdir, port = ckpts
    _same(t_load_partial(_template(_tree(0.0)), port[fmt]), load_partial(_tree(0.0), jdir))


@pytest.mark.parametrize("fmt", FORMATS)
def test_ignore_keys_prefix_drop(ckpts, fmt, capsys):
    jdir, port = ckpts
    got = t_load_partial(_template(_tree(0.0)), port[fmt], ignore_keys=(OUT_KEY[fmt],))
    _same(got, load_partial(_tree(0.0), jdir, ignore_keys=("unet/params/out",)))
    assert float(got["out.weight"].abs().max()) == 0.0  # fresh
    assert "init_from: deleting key out.weight from checkpoint" in capsys.readouterr().out
    if fmt == "pt":  # the bare port name matches too
        _same(t_load_partial(_template(_tree(0.0)), port[fmt], ignore_keys=("out",)),
              load_partial(_tree(0.0), jdir, ignore_keys=("unet/params/out",)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_only_model_restricts_to_unet(ckpts, fmt):
    jdir, port = ckpts
    got = t_load_partial(_template(_tree(0.0)), port[fmt], only_model=True)
    _same(got, load_partial(_tree(0.0), jdir, only_model=True))
    assert float(got["refiner.w"].abs().max()) == 0.0


@pytest.mark.parametrize("fmt", FORMATS)
def test_source_ema_and_bare_template(ckpts, fmt):
    jdir, port = ckpts
    bare = _tree(0.0)["unet"]
    got = t_load_partial(_template(bare), port[fmt], source="ema_params")
    _same(got, load_partial(bare, jdir, source="ema_params"))
    assert float(got["in.weight"][0, 0]) == 10.0
    _same(t_load_partial(_template(bare), port[fmt], source="ema"), load_partial(bare, jdir, source="ema_params"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_shape_mismatch_skipped_nonstrict(ckpts, fmt, capsys):
    jdir, port = ckpts
    got = t_load_partial(_template(_tree(0.0, head=6)), port[fmt])
    _same(got, load_partial(_tree(0.0, head=6), jdir))
    assert got["out.weight"].shape == (6,)
    assert "(0 missing, 0 unexpected, 1 shape-mismatched)" in capsys.readouterr().out


@pytest.mark.parametrize("fmt", FORMATS)
def test_g_params_fallback(tmp_path, fmt, capsys):
    mgr = CheckpointManager(tmp_path / "ae")
    g = {"params": {"w": np.full(3, 5.0, np.float32)}}
    mgr.save(3, {"g_params": g, "d_params": {"params": {"w": np.zeros(3, np.float32)}}})
    mgr.wait()
    if fmt == "npz":
        path = _flat_npz(tmp_path / "ae.npz", {"g_params": g, "d_params": {"params": {"w": np.zeros(3, np.float32)}}})
    else:
        TManager(tmp_path / "port").save(3, {"g_params": {"w": torch.full((3,), 5.0)}, "d_params": {},
                                             "step": 3})
        path = str(tmp_path / "port")
    tpl = {"params": {"w": np.zeros(3, np.float32)}}
    got = t_load_partial(ae_state_dict_from_jax(tpl), path, bridge=ae_state_dict_from_jax)
    _same(got, load_partial(tpl, tmp_path / "ae"), ae_state_dict_from_jax)
    assert "no 'params' in checkpoint — using 'g_params'" in capsys.readouterr().out


def test_weight_only_snapshots_keep_all(tmp_path):
    """trainstep snapshots are never pruned and a snapshot file is an
    init_from source (its `params`)."""
    mgr = TManager(tmp_path / "ck", max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": {"w": torch.full((2,), float(s))}})
        mgr.save_weights(s, {"params": {"w": torch.full((2,), float(s))}, "step": s})
    steps = mgr.all_steps()
    assert steps["rolling"] == [3, 4] and steps["trainstep"] == [1, 2, 3, 4]
    got = t_load_partial({"w": torch.zeros(2)}, tmp_path / "ck" / "trainstep" / "2.pt")
    assert torch.equal(got["w"], torch.full((2,), 2.0))


@pytest.mark.parametrize("fmt", FORMATS)
def test_maybe_init_from_config_plumbing(ckpts, fmt, capsys):
    """The str form, the dict form, resume precedence (`load_from`, or
    `resume` under `resume_key='resume'`), and no init_from at all."""
    jdir, port = ckpts
    from jointimagegeneration_tpu.cli.common import maybe_init_from as j_maybe

    def params():
        return [(n, torch.nn.Parameter(v)) for n, v in _template(_tree(0.0)).items()]

    named = params()
    assert maybe_init_from({"init_from": port[fmt]}, named)
    _same({n: p.detach() for n, p in named}, j_maybe({"init_from": str(jdir)}, _tree(0.0)))
    named = params()
    spec = {"path": port[fmt], "only_model": True, "source": "ema_params"}
    maybe_init_from({"init_from": spec}, named)
    _same({n: p.detach() for n, p in named},
          j_maybe({"init_from": {**spec, "path": str(jdir)}}, _tree(0.0)))
    for resume in ({"load_from": True}, {"resume": True}):
        named = params()
        assert not maybe_init_from({"init_from": port[fmt], **resume}, named)
        assert all(float(p.detach().abs().max()) == 0.0 for _, p in named)
    assert "init_from: ignored — run is resuming from its own checkpoints" in capsys.readouterr().out
    assert not maybe_init_from({"resume": True, "init_from": port[fmt]}, params(), resume_key="resume")
    assert not maybe_init_from({}, params())


def test_load_partial_real_model_tree(tmp_path):
    """A tiny text-guided MaskSampler: a port checkpoint of one seed into a
    fresh model of another; `only_model` leaves the refiner fresh, the full
    surgery loads it too."""
    from jointimagegeneration_torch.models.mask_sampler import MaskSampler

    kw = dict(num_classes=3, time_steps=8, model_channels=4, channel_mult=(1,), attention_resolutions=(),
              num_res_blocks=1, num_head_channels=2, context_dim=8, device="cpu",
              text_refiner={"embed_dim": 8, "n_heads": 2, "model_depth": 1, "d_head": 4})
    trained, fresh = MaskSampler.create(seed=1, **kw), MaskSampler.create(seed=2, **kw)
    TManager(tmp_path / "ck").save(5, {"params": {n: p.detach() for n, p in trained.named_parameters()}, "step": 5})
    before = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    assert maybe_init_from({"init_from": {"path": str(tmp_path / "ck"), "only_model": True}},
                           fresh.named_parameters())
    for (n, a), (_, b) in zip(fresh.named_parameters(), trained.named_parameters()):
        assert torch.equal(a, before[n] if n.startswith("refiner.") else b), n
    maybe_init_from({"init_from": str(tmp_path / "ck")}, fresh.named_parameters())
    for (n, a), (_, b) in zip(fresh.named_parameters(), trained.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("fmt", FORMATS)
def test_ignore_keys_match_bare_source_paths(tmp_path, fmt, capsys):
    """A bare source (an AE generator's flax variables, no 'unet' wrapper)
    honours ignore keys written as its natural paths: 'params/decoder' in the
    `.npz`, 'decoder' in a port `.pt`; a key that matches nothing warns."""
    bare = {"params": {"encoder": {"kernel": np.full((2, 2), 1.0, np.float32)},
                       "decoder": {"kernel": np.full((2, 2), 2.0, np.float32)}}}
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, {"params": bare})
    mgr.wait()
    if fmt == "npz":
        path, key = _flat_npz(tmp_path / "bare.npz", {"params": bare}), "params/decoder"
    else:
        TManager(tmp_path / "port").save(1, {"params": ae_state_dict_from_jax(bare)})
        path, key = str(tmp_path / "port"), "decoder"
    tpl = {"params": {"encoder": {"kernel": np.zeros((2, 2), np.float32)},
                      "decoder": {"kernel": np.zeros((2, 2), np.float32)}}}
    got = t_load_partial(ae_state_dict_from_jax(tpl), path, ignore_keys=(key,), bridge=ae_state_dict_from_jax)
    _same(got, load_partial(tpl, tmp_path / "ck", ignore_keys=("params/decoder",)), ae_state_dict_from_jax)
    assert float(got["decoder.weight"].abs().max()) == 0.0
    capsys.readouterr()
    t_load_partial(ae_state_dict_from_jax(tpl), path, ignore_keys=("no/such/prefix",), bridge=ae_state_dict_from_jax)
    assert "matched no checkpoint leaves" in capsys.readouterr().out


def test_other_formats_raise_naming_them(tmp_path):
    (tmp_path / "w.ckpt").write_bytes(b"x")
    (tmp_path / "empty").mkdir()
    for bad, what in ((tmp_path / "w.ckpt", "unsupported checkpoint format"), (tmp_path / "nope", "unsupported"),
                      (tmp_path / "empty", "no <step>.pt")):
        with pytest.raises(ValueError, match=what):
            t_load_partial({"w": torch.zeros(2)}, bad)
    torch.save({"opt": {}}, tmp_path / "x.pt")
    with pytest.raises(KeyError, match="params/ema_params/g_params"):
        t_load_partial({"w": torch.zeros(2)}, tmp_path / "x.pt")


# ------------------------------------------------------------- the CLIs --

def _check_surgery(model_params, source: dict, fresh: dict, dropped: str):
    for n, p in model_params:
        want = fresh[n] if n.startswith(dropped) else source[n]
        assert torch.equal(p.detach(), want), n


def test_init_from_through_train_mask(tmp_path, capsys):
    """stage 1: 0 steps after the surgery (max_steps 0), so the state holds
    the warm start; `out_conv` at fresh init, every other leaf the source's."""
    from jointimagegeneration_torch.cli import train_mask

    from test_torch_train import _tiny_cfg

    cfg = _tiny_cfg(tmp_path / "r", max_steps=0, validate=False)
    src = train_mask.build_mask_sampler(cfg, "cpu", seed=9)
    TManager(tmp_path / "src").save(3, {"params": {n: p.detach() for n, p in src.named_parameters()}})
    fresh = {n: p.detach() for n, p in train_mask.build_mask_sampler(cfg, "cpu", seed=0).named_parameters()}
    state = train_mask.run({**cfg, "init_from": {"path": str(tmp_path / "src"), "ignore_keys": ["out_conv"]}}, "e")
    _check_surgery(zip(state.names, state.params), dict(src.named_parameters()), fresh, "out_conv")
    n = len(fresh)
    assert f"init_from: restored {n - 2}/{n} leaves" in capsys.readouterr().out


def test_init_from_through_train_ldm(tmp_path, capsys):
    from jointimagegeneration_torch.cli import train_ldm
    from jointimagegeneration_torch.cli.sample import build_slice_ldm

    from test_torch_ldm_train import _tiny_cfg

    cfg = _tiny_cfg(tmp_path / "r", max_steps=0, validate=False)
    src = build_slice_ldm(cfg["model"], "cpu", seed=9, learn_logvar=True)
    fresh = dict(build_slice_ldm(cfg["model"], "cpu", seed=0, learn_logvar=True).named_parameters())
    TManager(tmp_path / "src").save(3, {"ema": {n: p.detach() for n, p in src.named_parameters()}})
    spec = {"path": str(tmp_path / "src"), "ignore_keys": ["out_conv"], "source": "ema_params"}
    state = train_ldm.run({**cfg, "init_from": spec}, "e")
    _check_surgery(zip(state.names, state.params), dict(src.named_parameters()), fresh, "out_conv")
    # a resume ignores it
    train_ldm.run({**cfg, "init_from": spec, "resume": True}, "e2")
    assert "init_from: ignored — run is resuming" in capsys.readouterr().out


def test_init_from_through_train_ae(tmp_path):
    """The generator's surgery, from a JAX `.npz` of AE variables (bridged
    by name) with the decoder's `conv_out` dropped."""
    from jointimagegeneration_torch.cli import train_ae
    from jointimagegeneration_torch.cli.common import build_autoencoder

    from test_torch_gan import _cli_cfg

    cfg = {**_cli_cfg(tmp_path), "max_steps": 0}
    src = build_autoencoder(cfg["model"], "cpu", seed=9)
    fresh = {n: p.detach() for n, p in build_autoencoder(cfg["model"], "cpu", seed=0).named_parameters()}
    flat = {}
    for n, p in src.named_parameters():  # the port's names back to a flax-like tree: kernels re-laid
        a = p.detach().numpy()
        leaf = n.rsplit(".", 1)
        if leaf[1] == "weight" and a.ndim >= 2:
            a = a.T if a.ndim == 2 else np.transpose(a, (*range(2, a.ndim), 1, 0))
            leaf[1] = "kernel"
        elif leaf[1] == "weight":
            leaf[1] = "scale"
        flat["g_params/params/" + "/".join(leaf[0].split(".") + [leaf[1]])] = a
    np.savez(tmp_path / "ae.npz", **flat)
    want = ae_state_dict_from_jax({k[len("g_params/"):]: v for k, v in flat.items()})
    assert all(torch.equal(want[n], p.detach()) for n, p in src.named_parameters())
    state = train_ae.run({**cfg, "init_from": {"path": str(tmp_path / "ae.npz"),
                                               "ignore_keys": ["decoder.conv_out"]}}, "e", device="cpu")
    _check_surgery(zip([n for n, _ in src.named_parameters()], state.g_params), dict(src.named_parameters()), fresh,
                   "decoder.conv_out")
