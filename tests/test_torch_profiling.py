"""The port's profiling hooks (``btia_tpu_torch/utils/profiling.py``) on the
CPU, mirroring ``tests/test_utils.py``'s: ``Timer.span`` counts and
accumulates, ``fetch`` returns host copies in the tree's structure,
``memory_stats`` is ``{}`` for the CPU and refuses a missing card, and
``trace`` writes a Chrome trace."""

import json

import pytest
import torch

from btia_tpu_torch.utils.profiling import Timer, fetch, memory_stats, trace


def test_timer_span():
    t = Timer()
    x = torch.ones(8, 8)
    with t.span(result=x * 2):
        x * 2
    with t.span():
        pass
    out = []
    with t.span(result=out):  # a list the block fills
        out.append(x @ x)
    assert t.count == 3 and t.total > 0
    assert t.mean_ms == pytest.approx(1000 * t.total / 3)


def test_fetch_returns_host_copies():
    a, b = torch.ones(3), torch.zeros(2, dtype=torch.bfloat16)
    out = fetch({"a": a, "b": [b, (a, "text")], "n": 3})
    assert torch.equal(out["a"], a) and out["a"].data_ptr() != a.data_ptr()
    assert out["b"][0].dtype == torch.bfloat16 and isinstance(out["b"][1], tuple)
    assert out["b"][1][1] == "text" and out["n"] == 3
    a.add_(1)
    assert torch.equal(out["a"], torch.ones(3))  # a copy, not a view


def test_memory_stats():
    assert memory_stats("cpu") == {}
    if torch.cuda.is_available():
        assert "allocated_bytes.all.current" in memory_stats()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            memory_stats()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "trace") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
