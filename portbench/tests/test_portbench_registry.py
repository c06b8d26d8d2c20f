"""A later change adds a configuration, a mix, a per-layer metric and a
cell as files and entries, and the harness finds them by name, editing no
file that is there."""

import json
import shutil
from pathlib import Path

from portbench.bench import Registry
from portbench.tests.tiny import tiny_run

BENCH = Path(__file__).resolve().parent.parent


def test_added_files_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "streaming_vitl.json").read_text())
    cfg["name"] = "streaming_vitl_copy"
    (bench / "configs" / "streaming_vitl_copy.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic" / "fanout-backlog.json").read_text())
    mix["questions"]["per_request"]["n"] = 64
    (bench / "traffic" / "fanout-64.json").write_text(json.dumps(mix))
    (bench / "limits" / "new-cell.json").write_text((BENCH / "limits" / "vitl-fanout-backlog.json").read_text())
    (bench / "metrics" / "answered_pairs.new.py").write_text(
        "def read(ctx):\n    return ctx.get('real_pairs') or None\n")
    spec["configs"].append({"name": "streaming_vitl_copy", "source": "https://arxiv.org/abs/2010.11929",
                            "file": "portbench/configs/streaming_vitl_copy.json", "reduced": [], "why": "a copy"})
    spec["workloads"].append({"name": "new-cell", "config": "streaming_vitl_copy", "traffic": "fanout-64",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "answered_pairs.new", "unit": "pairs", "better": "higher",
                              "source": "program_counter", "layer": "Server", "moves": "pairs_per_s",
                              "workloads": ["new-cell"]})
    spec["end_to_end"][0]["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    reg = Registry(bench=bench, spec=tmp_path / "BENCHMARK.json")
    assert reg.config(reg.cell("new-cell")["config"])["name"] == "streaming_vitl_copy"
    assert reg.mix("fanout-64")["questions"]["per_request"]["n"] == 64
    assert [m["name"] for m in reg.metrics_of("new-cell", trace=True)] == ["answered_pairs.new"]
    run = tiny_run("new-cell", reg=reg)
    assert run.correct and reg.reader("answered_pairs.new")(run.ctx) > 0
