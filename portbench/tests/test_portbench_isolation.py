"""The benchmark runs the port and nothing of the JAX package: no module
under portbench/ imports ``jax``, ``jaxlib``, ``flax`` or ``btia_tpu``
(top-level names compared whole, since ``btia_tpu_torch`` begins with
``btia_tpu``), and the reference under portbench/reference/ imports nothing
of the port either, nor any benchmark module that does."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "btia_tpu"}


def imported(path: Path) -> set:
    """Every module a file imports, dotted, relative imports resolved."""
    tree = ast.parse(path.read_text())
    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[: len(parts) - node.level + 1] + ([base] if base else []))
            out.add(base)
            out |= {f"{base}.{a.name}" for a in node.names}
    return out


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    tops = {m.split(".", 1)[0] for m in imported(path)}
    assert not tops & FORBIDDEN, f"{path} imports {sorted(tops & FORBIDDEN)}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    mods = imported(path)
    tops = {m.split(".", 1)[0] for m in mods}
    assert "btia_tpu_torch" not in tops and not tops & FORBIDDEN
    # within the benchmark, only the reference itself
    own = {m for m in mods if m.split(".", 1)[0] == "portbench"}
    assert all(m == "portbench.reference" or m.startswith("portbench.reference.") for m in own), own


def test_the_names_are_compared_whole():
    assert "btia_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "btia_tpu.models".split(".", 1)[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    probe = (
        "import importlib, pkgutil, sys, portbench\n"
        "for m in pkgutil.walk_packages(portbench.__path__, 'portbench.'):\n"
        "    if '.tests' not in m.name:\n"
        "        importlib.import_module(m.name)\n"
        "import portbench.reference.model, portbench.reference.train\n"
        "print(sorted({k.split('.', 1)[0] for k in sys.modules} & {'jax', 'jaxlib', 'flax', 'btia_tpu'}))\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
