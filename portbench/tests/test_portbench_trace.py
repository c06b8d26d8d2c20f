"""The trace readers on synthetic profiler traces: the interval union and
idle share, the window range, the hook-range attribution of the Dense and
LayerNorm rooflines, and the breakdown."""

import pytest

from portbench import flops
from portbench.bench import Registry
from portbench.trace import WINDOW, Trace, idle_gaps, union_length


def test_union_merges_overlaps_and_clips():
    assert union_length([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert union_length([(0, 10), (5, 15), (20, 30)], 8, 25) == 12
    assert idle_gaps([(0, 10), (5, 15), (20, 30)], 0, 40) == [(15, 20), (30, 40)]


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def synthetic():
    """A 1000 us window: two Dense calls (2048 x 768 -> 3072), each launching
    a GEMM and a bias add; one LayerNorm call; a kernel outside any range."""
    dense = "portbench.dense|2048|768|3072|2"
    ln = "portbench.layernorm|2048|768|2|2"
    return [
        ev(WINDOW, "user_annotation", 0, 1000, tid=1),
        ev(dense, "user_annotation", 10, 30), ev("cudaLaunchKernel", "cuda_runtime", 12, 2, correlation=1),
        ev("cudaLaunchKernel", "cuda_runtime", 20, 2, correlation=2),
        ev("gemm", "kernel", 50, 100, tid=7, correlation=1), ev("add", "kernel", 150, 50, tid=7, correlation=2),
        ev(dense, "user_annotation", 300, 30), ev("cudaLaunchKernel", "cuda_runtime", 305, 2, correlation=3),
        ev("cudaLaunchKernel", "cuda_runtime", 310, 2, correlation=4),
        ev("gemm", "kernel", 400, 100, tid=7, correlation=3), ev("add", "kernel", 500, 50, tid=7, correlation=4),
        ev(ln, "user_annotation", 600, 10), ev("cuLaunchKernel", "cuda_driver", 602, 2, correlation=5),
        ev("layernorm_kernel", "kernel", 620, 40, tid=7, correlation=5),
        ev("cudaLaunchKernel", "cuda_runtime", 700, 2, correlation=6),
        ev("other", "kernel", 700, 100, tid=7, correlation=6),
        ev("aten::copy_", "cpu_op", 800, 150),
        ev("late", "kernel", 1200, 50, tid=7, correlation=7),
    ]


def test_busy_and_idle_in_the_window():
    t = Trace(synthetic())
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(440e-6)  # 150 + 150 + 40 + 100; 'late' is outside
    assert t.idle_share() == pytest.approx(56.0)


def test_kernels_are_attributed_to_their_calls():
    t = Trace(synthetic())
    d = t.range_device_time("portbench.dense|")
    assert d["#portbench.dense|2048|768|3072|2"] == 2
    assert d["portbench.dense|2048|768|3072|2"] == pytest.approx(300e-6)
    n = t.range_device_time("portbench.layernorm|")
    assert n["portbench.layernorm|2048|768|2|2"] == pytest.approx(40e-6)


def test_roofline_readers():
    reg = Registry()
    ctx = {"trace": Trace(synthetic())}
    dense = reg.reader("dense_roofline.serve")(ctx)
    assert dense == pytest.approx(100 * 2 * flops.dense_bound_s(2048, 768, 3072) / 300e-6)
    ln = reg.reader("layernorm_roofline.serve")(ctx)
    assert ln == pytest.approx(100 * flops.layernorm_bound_s(2048, 768, 2, 2) / 40e-6)
    assert reg.reader("idle_share.serve")(ctx) == pytest.approx(56.0)


def test_readers_find_nothing_without_device_events():
    reg = Registry()
    ctx = {"trace": Trace([ev(WINDOW, "user_annotation", 0, 1000)]), "kind": "serve"}
    for name in ("dense_roofline.serve", "layernorm_roofline.serve", "idle_share.serve", "step_mfu.serve"):
        assert reg.reader(name)(ctx) is None


def test_breakdown_names_ops_and_gaps():
    b = Trace(synthetic()).breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(200e-6)]
    assert len(b["idle_gaps"]) <= 10
    # the two longest: 200 .. 400 (inside the second Dense call's range
    # at its middle) and 800 .. 1000 (the host in aten::copy_)
    assert [g[1] for g in b["idle_gaps"][:2]] == [pytest.approx(200e-6)] * 2
    assert {g[0] for g in b["idle_gaps"][:2]} == {"portbench.dense|2048|768|3072|2", "aten::copy_"}
