"""The card's idle time of a traced window, split by what the launching
thread was doing: the program's own ``btia.*`` spans
(``btia_tpu_torch/utils/profiling.py::span``) on that thread.

The loop thread is the (pid, tid) with the most ranges in the window whose
name starts with the cell's loop prefix (``btia.serve.dispatch``,
``btia.train.forward``). Each idle instant of the window (no kernel,
memcpy or memset running: the set ``Trace.idle_share`` counts) goes to the
innermost ``btia.`` range open on the loop thread at that instant, the one
that started last; gaps are split at the ranges' boundaries. Seconds are
summed by the span's name before its ``|``; instants under no range go to
``UNATTRIBUTED``. Ranges on other threads, and the profiler's
``gpu_user_annotation`` copies of the ranges, are not read.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.trace import Trace, idle_gaps

PREFIX = "btia."
UNATTRIBUTED = ""
LOOP = {"serve": "btia.serve.dispatch", "train": "btia.train.forward"}


def _ranges(t: Trace) -> List[dict]:
    return [e for e in t.events if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)]


def loop_thread(t: Trace, loop_prefix: str) -> Optional[Tuple]:
    """The (pid, tid) with the most loop ranges in the window, or None."""
    n = Counter((e.get("pid"), e.get("tid")) for e in _ranges(t)
                if e["name"].startswith(loop_prefix) and t.in_window(e))
    return n.most_common(1)[0][0] if n else None


def _segments(ranges: List[Tuple[float, float, str]], lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """[lo, hi) cut at every range boundary, each piece named by the
    innermost range open over it (the latest start; of equal starts the
    earliest end), or UNATTRIBUTED."""
    cuts = sorted({lo, hi} | {x for a, b, _ in ranges for x in (a, b) if lo < x < hi})
    starts = sorted(ranges)
    out, active, k = [], [], 0
    for x, y in zip(cuts, cuts[1:]):
        while k < len(starts) and starts[k][0] <= x:
            active.append(starts[k])
            k += 1
        # every end inside the window is a cut: a range open past x covers [x, y)
        active = [r for r in active if r[1] > x]
        best = max(active, key=lambda r: (r[0], -r[1]), default=None)
        out.append((x, y, best[2] if best else UNATTRIBUTED))
    return out


def idle_by_span(t: Trace, kind: str) -> Optional[Dict[str, float]]:
    """Idle seconds of the window by span name (UNATTRIBUTED for none);
    None where the trace has no device events or no loop-thread range."""
    if t is None or not t.has_device or t.hi <= t.lo:
        return None
    loop = loop_thread(t, LOOP[kind])
    if loop is None:
        return None
    mine = [(e["ts"], e["ts"] + e["dur"], e["name"].split("|", 1)[0]) for e in _ranges(t)
            if (e.get("pid"), e.get("tid")) == loop and e["ts"] < t.hi and e["ts"] + e["dur"] > t.lo]
    out: Dict[str, float] = defaultdict(float)
    segs = _segments(mine, t.lo, t.hi)
    i = 0
    for g0, g1 in idle_gaps(t.intervals, t.lo, t.hi):
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            x, y, name = segs[j]
            out[name] += (min(y, g1) - max(x, g0)) / 1e6
            j += 1
    return dict(out)


def idle_pct(ctx: dict, kind: str, span: str) -> Optional[float]:
    """The share of the traced window, in %, that the card idled while the
    loop thread was inside `span` (innermost)."""
    t = ctx.get("trace")
    by = idle_by_span(t, kind)
    return None if by is None else 100.0 * by.get(span, 0.0) / t.window_s
