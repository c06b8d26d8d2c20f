"""Device traces of the measured window, and their reduction to numbers.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) around the
window and writes the Chrome trace into the run's scratch folder; with
``hook_layers`` it registers forward pre/post hooks on the program's
``Dense`` and ``LayerNorm`` modules that open a ``record_function`` range
per call, named with the call's shape, so that the kernels each call
launched can be attributed to it whatever implements it.

``Trace`` reads such a file: device intervals (kernels, memcpys, memsets),
their union inside the window (the busy time), the window itself (the
``portbench.window`` range), the top kernels by time, the longest idle
gaps by what the launching thread was doing, and the device time of the
kernels launched inside ranges of a given prefix (through the launch's
correlation id).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SECONDS = 10.0  # the traced span: the window's last seconds


def trace_span(seconds: float) -> float:
    """Seconds of a window of `seconds` that the profiler runs over, at its
    end: ``TRACE_SECONDS``, or half a shorter window. The span before it is
    the one the model FLOPs rate is taken over."""
    return min(TRACE_SECONDS, seconds / 2)


def union_length(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals, clipped to [lo, hi)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The gaps in [lo, hi) that no interval covers, as (start, end)."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a >= hi:
            break
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return gaps


class Trace:
    """A Chrome trace as torch.profiler exports it (times in microseconds)."""

    def __init__(self, events: List[dict]):
        self.events = [e for e in events if e.get("ph") == "X"]
        self.device = [e for e in self.events if e.get("cat") in DEVICE_CATS]
        win = [e for e in self.events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if win:
            self.lo, self.hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        elif self.device:
            self.lo = min(e["ts"] for e in self.device)
            self.hi = max(e["ts"] + e["dur"] for e in self.device)
        else:
            self.lo = self.hi = 0.0
        self.intervals = [(e["ts"], e["ts"] + e["dur"]) for e in self.device]

    @classmethod
    def load(cls, path: Path) -> "Trace":
        return cls(json.loads(Path(path).read_text()).get("traceEvents", []))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length(self.intervals, self.lo, self.hi) / 1e6

    @property
    def has_device(self) -> bool:
        return bool(self.device)

    def idle_share(self) -> Optional[float]:
        if not self.device or self.hi <= self.lo:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def link_stats(self) -> dict:
        """How many device events the trace holds, and how many of them have
        a host launch with the same correlation id."""
        corr = {e["args"]["correlation"] for e in self.events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
        linked = sum(e.get("args", {}).get("correlation") in corr for e in self.device)
        return {"events": len(self.events), "device": len(self.device), "device_linked": linked}

    def in_window(self, e: dict) -> bool:
        return self.lo <= e["ts"] < self.hi

    def device_time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for e in self.device:
            if self.in_window(e):
                out[e["name"]] += e["dur"] / 1e6
        return out

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.device_time_by_name().items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(idle_gaps(self.intervals, self.lo, self.hi), key=lambda g: g[0] - g[1])[:n]
        host = [e for e in self.events if e.get("cat") in ("cpu_op", "user_annotation", "python_function")
                and e.get("name") != WINDOW]
        host.sort(key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]

        def doing(t: float) -> str:
            # the innermost host range open at t (the latest start that covers it)
            i = bisect.bisect_right(starts, t)
            best = None
            for e in reversed(host[max(0, i - 2000) : i]):
                if e["ts"] + e["dur"] >= t and (best is None or e["dur"] < best["dur"]):
                    best = e
            return best["name"] if best else "host: no op"

        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[doing((a + b) / 2), (b - a) / 1e6] for a, b in gaps]}

    def range_device_time(self, prefix: str) -> Dict[str, float]:
        """Device seconds of the kernels launched inside each host range
        whose name starts with `prefix`, keyed by the range's name (summed
        over calls of one name), and the count of such calls under
        key "#<name>". A kernel is attributed through its launch's
        correlation id to the innermost range open on the launching thread
        at the launch."""
        ranges: Dict[tuple, List[dict]] = defaultdict(list)
        for e in self.events:
            if e.get("cat") == "user_annotation" and e["name"].startswith(prefix) and self.in_window(e):
                ranges[(e.get("pid"), e.get("tid"))].append(e)
        for v in ranges.values():
            v.sort(key=lambda e: e["ts"])
        range_starts = {k: [r["ts"] for r in v] for k, v in ranges.items()}
        launches = {}
        for e in self.events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = e
        out: Dict[str, float] = defaultdict(float)
        for r in (r for v in ranges.values() for r in v):
            out["#" + r["name"]] += 1
        for k in self.device:
            corr = k.get("args", {}).get("correlation")
            launch = launches.get(corr)
            if launch is None or not self.in_window(k):
                continue
            key = (launch.get("pid"), launch.get("tid"))
            rs, starts = ranges.get(key, []), range_starts.get(key, [])
            i = bisect.bisect_right(starts, launch["ts"])
            for r in reversed(rs[max(0, i - 8) : i]):
                if r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]:
                    out[r["name"]] += k["dur"] / 1e6
                    break
        return dict(out)


class Tracer:
    """Profile the window's last ``trace_span`` seconds: ``start`` opens the
    profiler and the traced span's range, ``stop`` closes both (the caller
    checks the clock for each), ``load`` exports and reads the trace. With
    `hook_layers`, the Dense / LayerNorm range hooks are registered on
    `model` while the profiler runs."""

    def __init__(self, path: Path, model=None, hook_layers: bool = False):
        self.path, self.model, self.hook_layers = Path(path), model, hook_layers
        self.handles = []
        self.prof = self.window = None
        self.start_s = 0.0

    def _hooks(self):
        import torch
        from btia_tpu_torch.models.layers import Dense, LayerNorm

        enter = torch.ops.profiler._record_function_enter_new
        leave = torch.ops.profiler._record_function_exit
        stack = []

        def pre(name_of):
            def hook(mod, args):
                stack.append(enter(name_of(mod, args[0]), None))
            return hook

        def post(mod, args, out):
            leave(stack.pop())

        def dense_name(mod, x):
            K, N = mod.kernel.shape
            return f"portbench.dense|{x.numel() // K}|{K}|{N}|{mod.policy.compute_dtype.itemsize}"

        def ln_name(mod, x):
            D = x.shape[-1]
            return f"portbench.layernorm|{x.numel() // D}|{D}|{x.element_size()}|{mod.policy.compute_dtype.itemsize}"

        for m in self.model.modules():
            if type(m) is Dense:
                self.handles += [m.register_forward_pre_hook(pre(dense_name)), m.register_forward_hook(post)]
            elif type(m) is LayerNorm:
                self.handles += [m.register_forward_pre_hook(pre(ln_name)), m.register_forward_hook(post)]

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])

    def prepare(self) -> "Tracer":
        """Set-up: one short profiled op, so that the profiler's first start
        in the process (its device tracing initialised) is not in the
        window."""
        import torch
        from torch.profiler import profile

        dev = "cuda" if torch.cuda.is_available() else "cpu"
        with profile(activities=self._activities()):
            torch.ones(8, device=dev).sum().item()
        return self

    def start(self) -> "Tracer":
        """Start the traced span; the seconds it took are ``start_s``."""
        import time

        import torch
        from torch.profiler import profile, record_function

        t = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.hook_layers:
            self._hooks()
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self.window = record_function(WINDOW)
        self.window.__enter__()
        self.start_s = time.perf_counter() - t
        return self

    @property
    def running(self) -> bool:
        return self.window is not None

    def stop(self) -> None:
        """End the traced span (once, on the thread that started it)."""
        import torch

        if self.window is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window.__exit__(None, None, None)
        self.window = None
        self.prof.__exit__(None, None, None)
        for h in self.handles:
            h.remove()

    def load(self) -> Trace:
        """The trace of the span; empty where it never started."""
        if self.prof is None:
            return Trace([])
        self.stop()
        self.prof.export_chrome_trace(str(self.path))
        return Trace.load(self.path)
