"""The train driver across ranks, as a four-card cell would run it: the
process that runs the cell starts ranks 1-3 (``portbench/ranks.py``), each
trains its rows of the global batch, and rank 0 judges the all-reduced
steps against the reference over the global batch, each rank's dropout
masks drawn as the program draws them. On the CPU over gloo at a tiny size;
``traffic/vqa-med-train-dp4.json`` is the four-rank mix. The exchange
between the ranks left out is not correct."""

import json
import shutil
from pathlib import Path

import pytest

from portbench.bench import Registry
from portbench.tests.tiny import tiny_run

BENCH = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp4")
    bench = tmp / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(BENCH / sub, bench / sub)
    shutil.copy(BENCH / "limits" / "medfull-train.json", bench / "limits" / "medfull-train-dp4.json")
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "medfull-train-dp4", "config": "vqa_med_full",
                              "traffic": "vqa-med-train-dp4", "chips": 4, "why": "a test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(bench=bench, spec=tmp / "BENCHMARK.json")


def test_four_ranks_match_the_reference(reg):
    run = tiny_run("medfull-train-dp4", reg=reg)
    assert run.correct, run.checks
    assert run.ctx["allreduce_mb"] > 0 and run.ctx["chips"] == 4


@pytest.mark.parametrize("fault", ["no_allreduce", "half_batch"])
def test_a_broken_exchange_is_not_correct(reg, fault):
    run = tiny_run("medfull-train-dp4", reg=reg, fault=fault)
    assert not run.correct, run.checks
