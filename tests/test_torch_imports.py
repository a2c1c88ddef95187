"""PyTorch port: import hygiene and device selection.

The port and chip_smoke.py import neither JAX, flax nor the JAX package (the
machine with the card has none of them), the port imports PyYAML only when a
config file is read and `transformers` only inside
`FrozenBERTEmbedder.__init__` (nor has it `transformers`), `h5py` only inside
the slice dataset's optional cache (nor has it `h5py`), and an entry point
asked for no device on a machine without CUDA raises instead of running on
the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "jointimagegeneration_torch"
FORBIDDEN = ("jax", "flax", "jointimagegeneration_tpu")


def _imports(path: Path):
    """(module name, imported at module level?) for every import in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


def test_no_jax_imports_in_port_or_chip_smoke():
    bad = [(str(f.relative_to(ROOT)), m) for f in _port_sources() for m, _ in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_yaml_only_imported_inside_functions():
    bad = [(str(f.relative_to(ROOT)), m) for f in _port_sources() for m, top in _imports(f)
           if m.split(".")[0] == "yaml" and (top or f.name == "chip_smoke.py")]
    assert not bad, bad


def _scoped_imports(package: str) -> list:
    """(file, (class, method) or None) for every import of `package` in the
    port and chip_smoke.py."""
    found = []
    for f in _port_sources():
        tree = ast.parse(f.read_text(), filename=str(f))
        scopes = {}  # import node id -> the (class, function) it sits in
        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            for fn in [n for n in cls.body if isinstance(n, ast.FunctionDef)]:
                for node in ast.walk(fn):
                    scopes[id(node)] = (cls.name, fn.name)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            if any(n.split(".")[0] == package for n in names):
                found.append((str(f.relative_to(ROOT)), scopes.get(id(node))))
    return found


def test_transformers_only_imported_inside_frozen_bert_init():
    """Every import of `transformers` in the port sits in
    `nn/text.py`'s `FrozenBERTEmbedder.__init__`; chip_smoke.py has none."""
    found = _scoped_imports("transformers")
    assert found == [("jointimagegeneration_torch/nn/text.py", ("FrozenBERTEmbedder", "__init__"))], found


def test_h5py_only_imported_inside_the_slice_cache():
    """`h5py` is imported only where `RuijinSlicePairDataset` opens its
    `cache_h5` file; chip_smoke.py has none."""
    found = _scoped_imports("h5py")
    assert found == [("jointimagegeneration_torch/data/datasets.py", ("RuijinSlicePairDataset", "_load_case"))], found


def test_package_imports_with_jax_and_yaml_blocked():
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts) for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'jointimagegeneration_tpu', 'yaml', 'h5py', 'transformers'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "import chip_smoke\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_entry_points_without_device_raise_on_a_cuda_less_machine():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    from jointimagegeneration_torch.cli.sample import run
    from jointimagegeneration_torch.cli.train_mask import run as train_run
    from jointimagegeneration_torch.core.runtime import resolve_device
    from jointimagegeneration_torch.models.mask_sampler import MaskSampler
    from jointimagegeneration_torch.nn.unet import UNet

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        UNet(in_channels=2, model_channels=8, out_channels=1, channel_mult=(1,), dims=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MaskSampler.create(num_classes=4, model_channels=8, channel_mult=(1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        run({"stage": "two_stage", "output_path": "unused"})
    with pytest.raises(RuntimeError, match="CUDA"):
        train_run({"output_path": "unused"}, "exp")
    from jointimagegeneration_torch.cli.train_ldm import run as train_ldm_run

    with pytest.raises(RuntimeError, match="CUDA"):
        train_ldm_run({"output_path": "unused"}, "exp")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
