"""The benchmark's core: find a cell's configuration, traffic mix, limits
and per-layer metric readers by name, run the cell's driver, and assemble
the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Everything that
belongs to one configuration, mix or metric is a file of its own under the
benchmark's folder, found by its name:

- ``configs/<config>.json``: the program's configuration as it is run
  (``model``, ``data``, ``train``, ``mesh``), its source, ``reduced`` and
  ``assumed``;
- ``traffic/<mix>.json``: the parameters of the mix, which the one
  generator (``traffic.py``) reads; its ``kind`` names the driver,
  ``drivers/<kind>.py``;
- ``limits/<cell>.json``: each number that decides ``correct``, its limit
  and the readings it was set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric, ``read(ctx)``,
  returning a number or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"  # build and data caches, at fixed paths in the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "btia_tpu")


@dataclasses.dataclass
class Registry:
    """Where the benchmark's files are: `bench` is its folder, `spec` the
    ``BENCHMARK.json`` that names the cells."""

    bench: Path = HERE
    spec: Path = ROOT / "BENCHMARK.json"

    def benchmark(self) -> dict:
        return json.loads(self.spec.read_text())

    def cell(self, name: str) -> dict:
        cells = {w["name"]: w for w in self.benchmark()["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        return cells[name]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.benchmark()["configs"] if c["name"] == name)
        return json.loads((self.spec.parent / entry["file"]).read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench / "limits" / f"{cell}.json").read_text())

    def reader(self, metric: str) -> Callable:
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def metrics_of(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end (trace off) or per-layer (trace on) metrics."""
        b = self.benchmark()
        group = b["per_layer"] if trace else b["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def program_config(cfg_file: dict, overrides: Optional[dict] = None):
    """The program's Config from a configuration file (its four sections),
    with dotted `overrides` (CPU tests shrink widths this way)."""
    from btia_tpu_torch.configs.config import Config

    sections = {k: cfg_file[k] for k in ("model", "data", "train", "mesh")}
    cfg = Config.from_json(json.dumps({"name": cfg_file["name"], **sections}))
    return cfg.override(**overrides) if overrides else cfg


def model_dict(cfg) -> dict:
    return dataclasses.asdict(cfg.model)


@dataclasses.dataclass
class Run:
    """One run of one cell: its entries, and what the driver reports."""

    cell: dict
    cfg_file: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    overrides: Optional[dict] = None
    fault: Optional[str] = None  # a planted fault (tests and controls only)
    variant: Optional[str] = None  # "control": the lower-precision stand-in
    t_start: float = 0.0  # process start (perf_counter)
    scratch: Path = None
    rank: int = 0  # this process's rank, where the cell runs on several cards
    # filled by the driver
    setup_s: float = 0.0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    ctx: Dict[str, object] = dataclasses.field(default_factory=dict)
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    info: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def cfg(self):
        return program_config(self.cfg_file, self.overrides)

    def check(self, name: str, value: float, limit: float) -> None:
        """Record a compared number, correct at or under its limit; NaN fails."""
        self.checks[name] = {"value": value, "limit": limit, "ok": bool(value <= limit and not math.isnan(value))}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks.values())


def scratch_dir(cell: str) -> Path:
    """The run's own folder (vocabulary, the program's run directory,
    traces), new under TMPDIR; the driver removes it when the run ends."""
    return Path(tempfile.mkdtemp(prefix=f"portbench-{cell}-"))


def driver(kind: str):
    """The driver of a traffic kind: ``drivers/<kind>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", kind) or not (HERE / "drivers" / f"{kind}.py").is_file():
        raise KeyError(f"unknown traffic kind {kind!r}")
    return importlib.import_module(f"portbench.drivers.{kind}")


def drive(run: Run) -> Run:
    import shutil

    drv = driver(run.mix["kind"])
    run.scratch = scratch_dir(run.cell["name"])
    try:
        world = 1 if run.variant == "control" else int(run.mix.get("ranks", 1))
        if world == 1:
            drv.run(run)
            return run
        from portbench import ranks

        procs = ranks.start(run, world)
        try:
            drv.run(run)
        finally:
            others = ranks.join(run, procs)
        run.memory_peak_bytes = max([run.memory_peak_bytes] + [o["memory_peak_bytes"] for o in others])
        return run
    finally:
        shutil.rmtree(run.scratch, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted({k.split(".", 1)[0] for k in sys.modules} & set(FORBIDDEN))


def result_line(run: Run, reg: Registry, device_info: dict, breakdown: Optional[dict]) -> dict:
    metrics = {}
    for m in reg.metrics_of(run.cell["name"], run.trace):
        if run.trace:
            value = reg.reader(m["name"])(run.ctx)
        else:
            value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in run.checks.items()}
    return out


def print_checks(run: Run) -> None:
    for k, c in run.checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    print(f"correct: {run.correct}", file=sys.stderr)


def env_setup() -> None:
    """Cache directories inside the checkout, at fixed paths; no library may
    pull JAX in."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
