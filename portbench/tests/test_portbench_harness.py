"""The harness end to end on the CPU at a tiny size: each cell's driver runs
the program, times its window and judges it against the reference; the
command refuses to measure without a card; the per-layer readers report no
device metric from a CPU run."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.bench import Registry
from portbench.tests.tiny import tiny_run
from portbench.trace import trace_span

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in Registry().benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct(cell):
    run = tiny_run(cell)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert run.setup_s > 0
    for m in Registry().metrics_of(cell, trace=False):
        if m["name"] != "setup_s":
            assert run.e2e[m["name"]] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_no_device_metric_from_a_cpu_run(cell):
    run = tiny_run(cell, trace=True, seconds=1.0)
    reg = Registry()
    for m in reg.metrics_of(cell, trace=True):
        if m["source"] == "device_trace" or "mfu" in m["name"]:
            assert reg.reader(m["name"])(run.ctx) is None, m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_flops_rate_is_taken_before_the_profiler(cell):
    """The traced run's profiler covers the window's last seconds; the FLOPs
    rate counts only the work done in the span before it started."""
    run = tiny_run(cell, trace=True)
    assert run.ctx["mfu_seconds"] >= run.seconds - trace_span(run.seconds)
    assert run.ctx["mfu_flops"] > 0
    assert run.ctx["trace"].window_s > 0


def test_the_command_refuses_without_a_card():
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "3000000000",
                          "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    if res.returncode == 0:
        pytest.skip("this host has a card")
    assert res.stdout == "" and "no CUDA device" in res.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_json_names_files_that_exist():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    reg = Registry()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        reg.mix(w["traffic"])
        reg.limits(w["name"])
    for m in b["per_layer"]:
        reg.reader(m["name"])
