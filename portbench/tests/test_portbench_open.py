"""The open-loop serve driver, as the `vitl-mixed-open` cell would run it
(``traffic/mixed-open.json``, ``limits/vitl-mixed-open.json``): requests
handed out at their due times, latency from the due time, packed pairs
under a fixed budget. The cell is not in ``BENCHMARK.json`` (its tail did
not hold still enough on the card to bound); on the CPU at a tiny size."""

import json
import shutil
from pathlib import Path

import pytest

from portbench.bench import Registry
from portbench.tests.tiny import tiny_run

BENCH = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("open")
    bench = tmp / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "vitl-mixed-open", "config": "streaming_vitl", "traffic": "mixed-open",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                               "source": "host_clock", "workloads": ["vitl-mixed-open"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(bench=bench, spec=tmp / "BENCHMARK.json")


def test_open_loop_is_correct_and_timed_from_due_times(reg):
    run = tiny_run("vitl-mixed-open", reg=reg)
    assert run.correct, run.checks
    assert run.failed == 0 and run.e2e["latency_p95_ms"] > 0
    assert run.ctx["latency_p50_ms"] <= run.e2e["latency_p95_ms"]
    assert 0 < run.ctx["real_pairs"] <= run.ctx["slot_pairs"]


def test_open_loop_altered_answer_is_not_correct(reg):
    assert not tiny_run("vitl-mixed-open", reg=reg, fault="alter_answer").correct
