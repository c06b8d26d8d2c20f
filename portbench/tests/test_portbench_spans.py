"""The idle-time split by the program's spans (``portbench/spans.py``) and
its readers, on hand-built profiler traces: idle gaps that straddle span
boundaries, nested spans, a span open before the window, spans on another
thread and the profiler's ``gpu_user_annotation`` copies (both ignored);
the attribution exact and summing to the idle share; every reader None on
a trace without the program's spans."""

import random

import pytest

from portbench import spans
from portbench.bench import Registry
from portbench.trace import WINDOW, Trace

SERVE = ("idle_wait.serve", "idle_dispatch.serve", "idle_drain.serve", "idle_deliver.serve")
TRAIN = ("idle_data.train", "idle_to_device.train", "idle_forward.train", "idle_backward.train",
         "idle_optimizer.train")
READERS = SERVE + TRAIN + ("optimizer_ms.train",)


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def ann(name, a, b, tid=1):
    return ev(name, "user_annotation", a, b - a, tid=tid)


def kernel(a, b, corr=0):
    return ev("k", "kernel", a, b - a, tid=7, correlation=corr)


def serve_trace():
    """A 1000 us window; kernels on [100, 200), [300, 400), [600, 900), so
    the idle gaps are [0, 100), [200, 300), [400, 600), [900, 1000): 500 us.
    On the loop thread (1): wait [-50, 150) (opened before the window),
    dispatch|1 [150, 450) with drain|0 [250, 280) nested in it, deliver
    [450, 520), nothing over [520, 560), wait [560, 950), dispatch|2
    [960, 990). Thread 2 holds one dispatch and a wait over the whole
    window; a gpu_user_annotation copy of deliver covers [520, 560)."""
    return [
        ann(WINDOW, 0, 1000),
        kernel(100, 200), kernel(300, 400), kernel(600, 900),
        ann("btia.serve.wait", -50, 150), ann("btia.serve.dispatch|1", 150, 450),
        ann("btia.serve.drain|0", 250, 280), ann("btia.serve.deliver", 450, 520),
        ann("btia.serve.wait", 560, 950), ann("btia.serve.dispatch|2", 960, 990),
        ann("btia.serve.dispatch|9", 500, 600, tid=2), ann("btia.serve.wait", 0, 1000, tid=2),
        ev("btia.serve.deliver", "gpu_user_annotation", 520, 40, tid=7),
    ]


def test_idle_gaps_split_at_span_boundaries():
    t = Trace(serve_trace())
    assert t.idle_share() == pytest.approx(50.0)
    assert spans.loop_thread(t, "btia.serve.dispatch") == (1, 1)
    by = spans.idle_by_span(t, "serve")
    want = {"btia.serve.wait": 190e-6, "btia.serve.dispatch": 150e-6, "btia.serve.drain": 30e-6,
            "btia.serve.deliver": 70e-6, spans.UNATTRIBUTED: 60e-6}
    assert by.keys() == want.keys()
    for k, v in want.items():
        assert by[k] == pytest.approx(v, abs=1e-12), k
    assert abs(sum(by.values()) - t.window_s * t.idle_share() / 100) < 1e-9


def test_serve_readers():
    reg = Registry()
    ctx = {"trace": Trace(serve_trace()), "kind": "serve"}
    got = {m: reg.reader(m)(ctx) for m in SERVE}
    assert got == pytest.approx({"idle_wait.serve": 19.0, "idle_dispatch.serve": 15.0, "idle_drain.serve": 3.0,
                                 "idle_deliver.serve": 7.0})
    for m in TRAIN + ("optimizer_ms.train",):  # no train loop in a serve trace
        assert reg.reader(m)(ctx) is None, m


def train_trace():
    """Two steps on a 1000 us window: data wait [0, 100), to_device [100,
    150), then per step forward, backward and optimizer; the optimizer
    launches two kernels a step (correlation ids 11, 12; 21, 22)."""
    return [
        ann(WINDOW, 0, 1000),
        ann("btia.data.wait", 0, 100), ann("btia.train.to_device", 100, 150),
        ann("btia.train.forward|4", 150, 300), kernel(200, 320),
        ann("btia.train.backward|4", 300, 400), kernel(330, 380),
        ann("btia.train.optimizer|4", 400, 500),
        ev("cudaLaunchKernel", "cuda_runtime", 410, 5, correlation=11), kernel(420, 440, 11),
        ev("cudaLaunchKernel", "cuda_runtime", 450, 5, correlation=12), kernel(460, 470, 12),
        ann("btia.train.forward|5", 500, 650), kernel(600, 700),
        ann("btia.train.backward|5", 650, 800), kernel(720, 780),
        ann("btia.train.optimizer|5", 800, 900),
        ev("cudaLaunchKernel", "cuda_runtime", 805, 5, correlation=21), kernel(810, 850, 21),
        ev("cudaLaunchKernel", "cuda_runtime", 855, 5, correlation=22), kernel(860, 870, 22),
        kernel(950, 1000),
    ]


def test_train_readers():
    reg = Registry()
    t = Trace(train_trace())
    ctx = {"trace": t, "kind": "train"}
    got = {m: reg.reader(m)(ctx) for m in TRAIN}
    # idle: [0, 200) data 100, to_device 50, forward 50; [320, 330) and
    # [380, 400) backward; [400, 420), [440, 460), [470, 500) optimizer 70;
    # [500, 600) forward; [700, 720), [780, 800) backward; [800, 810),
    # [850, 860), [870, 900) optimizer 50; [900, 950) under no span
    assert got == pytest.approx({"idle_data.train": 10.0, "idle_to_device.train": 5.0, "idle_forward.train": 15.0,
                                 "idle_backward.train": 7.0, "idle_optimizer.train": 12.0})
    assert sum(got.values()) + 5.0 == pytest.approx(t.idle_share())
    # (20 + 10 + 40 + 10) us of optimizer kernels over two optimizer spans
    assert reg.reader("optimizer_ms.train")(ctx) == pytest.approx(0.040)
    for m in SERVE:
        assert reg.reader(m)(ctx) is None, m


@pytest.mark.parametrize("seed", range(6))
def test_attribution_matches_a_brute_force_walk(seed):
    """Random kernels and random (crossing, nested, equal-start) spans on
    integer microseconds: each idle microsecond goes to the span open over
    it that started last (of equal starts, the one that ends first)."""
    rng = random.Random(seed)
    names = ["btia.serve.wait", "btia.serve.dispatch", "btia.serve.drain", "btia.serve.deliver"]
    events = [ann(WINDOW, 0, 400)]
    for _ in range(25):
        a = rng.randrange(-20, 400)
        events.append(kernel(a, a + rng.randrange(1, 30)))
    for i in range(40):
        a = rng.randrange(-30, 400)
        b = a + rng.randrange(0, 80)
        tid = rng.choice([1, 1, 1, 2])
        name = rng.choice(names) if tid == 1 else "btia.serve.wait"
        events.append(ann(f"{name}|{i}", a, b, tid=tid))
    events.append(ann("btia.serve.dispatch|x", 0, 1, tid=1))  # thread 1 is the loop thread
    t = Trace(events)
    mine = [(e["ts"], e["ts"] + e["dur"], e["name"].split("|")[0]) for e in events
            if e["tid"] == 1 and e["name"].startswith("btia.")]
    want = {}
    for us in range(400):
        mid = us + 0.5
        if any(a <= mid < b for a, b in t.intervals):
            continue
        open_ = [r for r in mine if r[0] <= mid < r[1]]
        best = max(open_, key=lambda r: (r[0], -r[1]), default=None)
        key = best[2] if best else spans.UNATTRIBUTED
        want[key] = want.get(key, 0.0) + 1e-6
    got = spans.idle_by_span(t, "serve")
    assert {k for k, v in got.items() if v > 0} == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k
    assert abs(sum(got.values()) - t.window_s * t.idle_share() / 100) < 1e-9


def test_every_reader_finds_nothing_without_program_spans():
    """A trace of a program without these spans, one
    with no device events, and no trace at all: every reader is None."""
    reg = Registry()
    plain = [e for e in serve_trace() + train_trace() if not e["name"].startswith("btia.")]
    no_device = [e for e in serve_trace() + train_trace() if e["cat"] != "kernel"]
    for events in (plain, no_device):
        for kind in ("serve", "train"):
            ctx = {"trace": Trace(events), "kind": kind}
            for m in READERS:
                assert reg.reader(m)(ctx) is None, (m, kind)
    for m in READERS:
        assert reg.reader(m)({"kind": "train"}) is None, m
