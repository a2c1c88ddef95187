"""PyTorch port: import hygiene and device selection.

The port and chip_smoke.py import neither JAX, flax nor the JAX package (the
machine with the card has none of them), the port imports PyYAML only when a
config file is read and `transformers` only inside
`FrozenBERTEmbedder.__init__` (nor has it `transformers`), `h5py` only inside
the slice dataset's optional cache and `H5Dataset` (nor has it `h5py`), cv2
and PIL only inside the stock datasets' functions, and an entry point
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


READER_AND_AE_MODULES = ["cli/convert_reference.py", "cli/train_ae.py", "core/ref_import.py", "nn/discriminators.py",
                         "train/gan.py", "utils/torch_convert.py"]


@pytest.mark.parametrize("name", READER_AND_AE_MODULES)
def test_checkpoint_reader_and_ae_trainer_modules_import_no_jax_and_yaml_lazily(name):
    """The reference readers and the AE trainer's modules are among the
    files the checks above walk: no JAX, flax or JAX-package import, and
    `yaml` only inside a function (`core/ref_import._main`)."""
    path = PORT / name
    assert path in _port_sources()
    found = list(_imports(path))
    assert not [m for m, _ in found if m.split(".")[0] in FORBIDDEN], found
    assert not [m for m, top in found if m.split(".")[0] == "yaml" and top], found


SLICE_15_MODULES = ["nn/vae.py", "nn/vit.py", "models/cond_encoders.py", "eval/metrics.py", "eval/i3d.py",
                    "eval/fvd.py", "cli/convert_i3d.py", "cli/common.py"]


@pytest.mark.parametrize("name", SLICE_15_MODULES)
def test_vae_extras_fvd_and_dino_modules_import_no_jax_and_yaml_lazily(name):
    """The VAE extras, the ViT and its encoder route, the FVD metric, the I3D
    and its converter: no JAX, flax or JAX-package import (not even of the
    JAX package's jax-free converter script), and `yaml` only inside a
    function."""
    path = PORT / name
    assert path in _port_sources()
    found = list(_imports(path))
    assert not [m for m, _ in found if m.split(".")[0] in FORBIDDEN + ("scripts",)], found
    assert not [m for m, top in found if m.split(".")[0] == "yaml" and top], found


def _function_imports(package: str) -> list:
    """(file, enclosing function or None) for every import of `package` in
    the port and chip_smoke.py."""
    found = []
    for f in _port_sources():
        tree = ast.parse(f.read_text(), filename=str(f))
        owner = {}
        for fn in [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
            for node in ast.walk(fn):
                owner.setdefault(id(node), fn.name)  # ast.walk is breadth-first: the outermost function first
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            if any(n.split(".")[0] == package for n in names):
                found.append((str(f.relative_to(ROOT)), owner.get(id(node))))
    return sorted(found)


def test_scipy_only_imported_where_used():
    """`scipy` is imported only inside the functions that call it: the
    degradations' mirror convolution, kernel shift and correlated noise, the
    Hungarian match, the Frechet distance's matrix square root and the
    overlay's edge filter; chip_smoke.py has none."""
    assert _function_imports("scipy") == [
        ("jointimagegeneration_torch/data/degradation.py", "_add_gaussian_noise_light"),
        ("jointimagegeneration_torch/data/degradation.py", "_convolve_mirror"),
        ("jointimagegeneration_torch/data/degradation.py", "_shift_pixel"),
        ("jointimagegeneration_torch/eval/metrics.py", "_trace_sqrt_product"),
        ("jointimagegeneration_torch/eval/metrics.py", "hungarian_matched_iou"),
        ("jointimagegeneration_torch/eval/writers.py", "overlay_mask_on_image")], _function_imports("scipy")


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
    `cache_h5` file and where `data/generic.H5Dataset` opens its file (after
    `require_packages` has named the package if it is missing);
    chip_smoke.py has none."""
    found = _scoped_imports("h5py")
    assert found == [("jointimagegeneration_torch/data/datasets.py", ("RuijinSlicePairDataset", "_load_case")),
                     ("jointimagegeneration_torch/data/generic.py", ("H5Dataset", "__init__")),
                     ("jointimagegeneration_torch/data/generic.py", ("H5Dataset", "_file"))], found


def test_cv2_and_pil_only_imported_where_used():
    """The stock datasets import cv2 and PIL inside the functions that call
    them, as the JAX package does, so the port imports where neither is
    installed (the datasets check at construction, through `importlib`,
    that they import); chip_smoke.py imports PIL only in `_write_sr_tree`."""
    assert _function_imports("cv2") == sorted(
        [("jointimagegeneration_torch/data/degradation.py", f) for f in
         ("gaussian_blur", "jpeg_compress", "downsample_up", "degradation_pipeline", "_cv2_resize", "_add_jpeg_noise")]
        + [("jointimagegeneration_torch/data/stock.py", f) for f in ("_smallest_max_size", "__getitem__",
                                                                      "__getitem__")]), _function_imports("cv2")
    assert _function_imports("PIL") == [
        ("chip_smoke.py", "_write_sr_tree"),
        ("jointimagegeneration_torch/data/generic.py", "__getitem__"),
        ("jointimagegeneration_torch/data/generic.py", "_default_loader"),
        ("jointimagegeneration_torch/data/stock.py", "_load_rgb"),
        ("jointimagegeneration_torch/data/stock.py", "_pil_resize")], _function_imports("PIL")


SLICE_16_MODULES = ["data/degradation.py", "data/stock.py", "data/generic.py", "cli/serve.py", "parallel/mesh.py",
                    "parallel/__init__.py", "data/loader.py", "train/trainer.py"]


@pytest.mark.parametrize("name", SLICE_16_MODULES)
def test_serve_stock_data_and_mesh_modules_import_no_jax_and_yaml_lazily(name):
    """The server, the stock and generic datasets, the degradations, the
    data-parallel module and the modules it reaches: no JAX, flax or
    JAX-package import (the JAX loader's `jax.process_count` has its
    torch.distributed counterpart), and `yaml` only inside a function."""
    path = PORT / name
    assert path in _port_sources()
    found = list(_imports(path))
    assert not [m for m, _ in found if m.split(".")[0] in FORBIDDEN], found
    assert not [m for m, top in found if m.split(".")[0] == "yaml" and top], found


SLICE_17_MODULES = ["utils/misc.py", "models/classifier.py", "nn/text.py", "core/logging.py", "core/checkpoint.py",
                    "nn/unet.py", "nn/blocks.py", "models/slice_ldm.py", "models/latent_ldm.py", "train/steps.py",
                    "cli/train_ldm.py", "cli/train_mask.py", "utils/jax_weights.py"]


@pytest.mark.parametrize("name", SLICE_17_MODULES)
def test_trainer_extras_and_stage2_conditioning_modules_import_no_jax_and_yaml_lazily(name):
    """The misc utilities, the classifier, the stage-2 conditioners, the
    logger with its TensorBoard / W&B mirrors, the checkpoint surgery, the
    remat UNet and the conditioned samplers and steps: no JAX, flax or
    JAX-package import (not even of the JAX package's jax-free `utils/misc.py`),
    and `yaml` only inside a function."""
    path = PORT / name
    assert path in _port_sources()
    found = list(_imports(path))
    assert not [m for m, _ in found if m.split(".")[0] in FORBIDDEN + ("scripts",)], found
    assert not [m for m, top in found if m.split(".")[0] == "yaml" and top], found


SLICE_18_MODULES = ["parallel/spatial.py", "parallel/mesh.py", "nn/transformer.py", "ops/attention.py",
                    "models/mask_sampler.py", "cli/sample.py"]


@pytest.mark.parametrize("name", SLICE_18_MODULES)
def test_spatial_sharding_modules_import_no_jax_and_yaml_lazily(name):
    """The 'model' axis's exchanges, the single-controller mesh and the
    modules that take sharded activations or build a batch's data mesh: no
    JAX, flax or JAX-package import, and `yaml` only inside a function."""
    path = PORT / name
    assert path in _port_sources()
    found = list(_imports(path))
    assert not [m for m, _ in found if m.split(".")[0] in FORBIDDEN], found
    assert not [m for m, top in found if m.split(".")[0] == "yaml" and top], found


SLICE_19_MODULES = ["data/native.py", "data/datasets.py", "data/nifti.py", "data/generic.py", "ops/cuda/build.py",
                    "cli/sample.py"]


@pytest.mark.parametrize("name", SLICE_19_MODULES)
def test_native_data_route_modules_import_no_jax_and_yaml_lazily(name):
    """The native data route's bindings, the build module's host target and
    the modules that route through them: no JAX, flax or JAX-package import
    (not even of the JAX package's jax-free `data/native.py`), and `yaml`
    only inside a function."""
    path = PORT / name
    assert path in _port_sources()
    found = list(_imports(path))
    assert not [m for m, _ in found if m.split(".")[0] in FORBIDDEN], found
    assert not [m for m, top in found if m.split(".")[0] == "yaml" and top], found


def test_native_bindings_import_only_ctypes_numpy_and_the_port():
    """`data/native.py` imports ctypes, numpy and the standard library it
    needs, and of the port only the build module and the plain versions it
    stands for; it loads its library with JAX blocked."""
    tree = ast.parse((PORT / "data" / "native.py").read_text())
    absolute = sorted({m for m, _ in _imports(PORT / "data" / "native.py")})
    relative = sorted({(n.level, n.module) for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level})
    assert absolute == ["__future__", "ctypes", "numpy", "os", "threading", "typing"], absolute
    assert relative == [(1, "classes"), (1, "nifti"), (2, "ops.cuda")], relative
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'jointimagegeneration_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import jointimagegeneration_torch.data.native as n\n"
            "n.native_available()\n"
            "print('loaded')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "loaded" in out.stdout, out.stderr


def test_tensorboard_and_wandb_only_imported_where_asked_for():
    """`wandb` is imported only in `MetricLogger.__init__` when a project is
    given, TensorBoard's writers only by name inside `_tensorboard_writer`
    (so the port imports where neither is installed); chip_smoke.py imports
    neither."""
    assert _scoped_imports("wandb") == [("jointimagegeneration_torch/core/logging.py", ("MetricLogger", "__init__"))]
    assert _scoped_imports("tensorboardX") == [] and _function_imports("tensorboard") == []
    src = (PORT / "core" / "logging.py").read_text()
    assert '("tensorboardX", "torch.utils.tensorboard")' in src


def test_package_imports_with_jax_and_yaml_blocked():
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts) for p in PORT.rglob("*.py"))
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'jointimagegeneration_tpu', 'yaml', 'h5py', 'transformers', 'cv2', 'PIL',\n"
            "          'wandb', 'tensorboardX'):\n"
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
    from jointimagegeneration_torch.cli.train_ae import run as train_ae_run
    from jointimagegeneration_torch.nn.discriminators import PatchDiscriminator

    with pytest.raises(RuntimeError, match="CUDA"):
        train_ae_run({"output_path": "unused"}, "exp")
    with pytest.raises(RuntimeError, match="CUDA"):
        PatchDiscriminator(1)
    from jointimagegeneration_torch.cli.common import build_dino_feature_fn
    from jointimagegeneration_torch.eval.fvd import i3d_feature_fn, i3d_npz_feature_fn
    from jointimagegeneration_torch.nn.vit import ViTExtractor

    with pytest.raises(RuntimeError, match="CUDA"):
        ViTExtractor(model_type="vits16")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_dino_feature_fn({"dims": 2, "feature_cond_encoder": {"type": "dino"}}, (32, 32), None)
    for fn in (i3d_npz_feature_fn, i3d_feature_fn):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn("unused")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
