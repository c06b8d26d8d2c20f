"""The port stands alone: importing every module of ``btia_tpu_torch``
(the model, kernels, data, training and checkpoint modules) loads neither JAX
nor any module of ``btia_tpu``, and its entry points, serving and training
alike, do not fall back to the CPU when no GPU is present."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from btia_tpu_torch.configs import get_config
from btia_tpu_torch.core.device import resolve_device
from btia_tpu_torch.infer.predict import Predictor
from btia_tpu_torch.models.model import build_model
from btia_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import btia_tpu_torch
for m in pkgutil.walk_packages(btia_tpu_torch.__path__, "btia_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(
    k for k in sys.modules
    if k in ("jax", "flax", "btia_tpu") or k.startswith(("jax.", "flax.", "btia_tpu."))
)
print("LOADED", len([k for k in sys.modules if k.startswith("btia_tpu_torch")]))
print("PARALLEL", sorted(k for k in sys.modules if k.startswith("btia_tpu_torch.parallel") or k == "btia_tpu_torch.infer.sharded"))
print("BAD", bad)
"""


def test_no_jax_and_no_reference_package_imported():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    lines = dict(line.split(" ", 1) for line in res.stdout.strip().splitlines())
    assert int(lines["LOADED"]) >= 30
    assert lines["BAD"] == "[]"
    # the parallelism modules are among those walked
    assert lines["PARALLEL"] == str([
        "btia_tpu_torch.infer.sharded", "btia_tpu_torch.parallel", "btia_tpu_torch.parallel.collectives",
        "btia_tpu_torch.parallel.distributed", "btia_tpu_torch.parallel.mesh", "btia_tpu_torch.parallel.sharding",
    ])


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for hosts without one")
    cfg = get_config("streaming_vitl").model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(None, None, None, None, get_config("streaming_vitl"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


_TRAIN_MODULES = (
    "btia_tpu_torch.train.steps", "btia_tpu_torch.train.trainer", "btia_tpu_torch.train.checkpoint",
    "btia_tpu_torch.train.metrics", "btia_tpu_torch.utils.logging", "btia_tpu_torch.data.builder",
    "btia_tpu_torch.data.datasets", "btia_tpu_torch.data.pipeline", "btia_tpu_torch.data.image",
    "btia_tpu_torch.data.dicom", "btia_tpu_torch.data.synthetic", "btia_tpu_torch.data.native",
)


def test_training_modules_import_alone():
    """Each training and data module, imported by itself, pulls in no JAX."""
    probe = (
        "import importlib, sys\n"
        f"for m in {_TRAIN_MODULES!r}: importlib.import_module(m)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'btia_tpu')))\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_training_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for hosts without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(get_config("vqa_med_full"), tmp_path / "run")
    assert not (tmp_path / "run").exists()


_SERVING_MODULES = (
    "btia_tpu_torch.ops.quant", "btia_tpu_torch.infer.predict", "btia_tpu_torch.infer.streaming",
    "btia_tpu_torch.cli", "btia_tpu_torch.bench", "btia_tpu_torch.convert.convert",
    "btia_tpu_torch.convert.hf", "btia_tpu_torch.utils.profiling",
)


def test_serving_modules_import_alone():
    """K8's module, the serving modules and the user's entry points (the
    CLI, the bench, checkpoint conversion, profiling), imported by
    themselves, pull in no JAX and no module of the reference package."""
    probe = (
        "import importlib, sys\n"
        f"for m in {_SERVING_MODULES!r}: importlib.import_module(m)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'btia_tpu')))\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("argv", [
    ["train", "--config", "tiny_test", "--set", "data.data_dir=no_such_dir"],
    ["convert", "--config", "tiny_test", "--torch-ckpt", "no_such.pt"],
])
def test_cli_raises_without_a_gpu(argv, tmp_path):
    """The CLI without ``--device cpu`` on a host with no GPU ends on the
    device error and writes nothing: it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for hosts without one")
    from btia_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([*argv, "--workdir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_bench_raises_without_a_gpu():
    """``python -m btia_tpu_torch.bench`` without ``--device cpu`` on a host
    with no GPU fails before it builds a model; it never times the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for hosts without one")
    from btia_tpu_torch import bench

    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--config", "tiny_test", "--steps", "1"])


_OPS_MODULES = (
    "btia_tpu_torch.ops.bicross", "btia_tpu_torch.ops.norms", "btia_tpu_torch.ops.attention",
    "btia_tpu_torch.ops", "btia_tpu_torch.ops.gemm",
)


@pytest.mark.parametrize("module", _OPS_MODULES)
def test_ops_api_modules_import_alone(module):
    """The ops API (K5's, K6's and K7's modules, the dense GEMMs' module and
    the package that exports the reference's names), imported by itself,
    pulls in no JAX and no module of the reference package, and builds
    nothing."""
    probe = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "from btia_tpu_torch.ops import _native\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'btia_tpu')),"
        " _native.lib.cache_info().currsize)\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[] 0"


def test_models_import_no_private_name_of_the_ops():
    """The models reach the kernels through the ops modules' public names
    only: no file under ``btia_tpu_torch/models/`` imports a ``_``-prefixed
    name from ``btia_tpu_torch.ops``."""
    import ast

    private = []
    for path in sorted((REPO / "btia_tpu_torch" / "models").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("btia_tpu_torch.ops"):
                private += [f"{path.name}: {node.module}.{a.name}" for a in node.names if a.name.startswith("_")]
    assert private == []


def test_chip_smoke_imports_no_jax():
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "btia_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "flax", "btia_tpu"}, roots


def test_int8_kernel_entry_has_no_fallback():
    """K8 takes its plain twin only for a CPU tensor; any other device
    launches the kernel (CUDA) or raises, never a quiet plain product."""
    from btia_tpu_torch.ops.quant import int8_matmul_fused

    x = torch.empty(4, 16, device="meta", dtype=torch.bfloat16)
    w = torch.empty(16, 8, device="meta", dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul_fused(x, w, torch.empty(8, device="meta"))
    assert int8_matmul_fused.launches == 0


def test_package_exports_the_reference_api():
    """``from btia_tpu_torch import predict, __version__`` works: the root
    exports every public name of ``btia_tpu/__init__.py``."""
    import ast

    import btia_tpu_torch
    from btia_tpu_torch import __version__, predict
    from btia_tpu_torch.infer.predict import predict as module_predict

    tree = ast.parse((REPO / "btia_tpu" / "__init__.py").read_text())
    names = {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom) for a in n.names}
    names |= {t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets}
    assert "predict" in names and "__version__" in names
    assert names <= set(dir(btia_tpu_torch)), names - set(dir(btia_tpu_torch))
    assert predict is module_predict and isinstance(__version__, str)
