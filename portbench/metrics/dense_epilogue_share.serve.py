"""Per-layer metric ``dense_epilogue_share.serve``: the share, in %, of the
traced window's ``models/layers.py::Dense`` calls (the benchmark's
``portbench.dense|M|K|N|elem`` ranges) inside which the projection GEMM
with Dense's epilogue (``gemm_bias_ws_kernel``) launched: the calls whose
product, bias and activation ran as one kernel. A kernel is attributed as
``Trace.range_device_time`` attributes it: through its launch's
correlation id, to the innermost such range open on the launching thread
at the launch. A program without that route reads 0."""

import bisect
from collections import defaultdict

KERNEL = "gemm_bias_ws_kernel"
PREFIX = "portbench.dense|"


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.has_device:
        return None
    ranges = defaultdict(list)
    for e in t.events:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX) and t.in_window(e):
            ranges[(e.get("pid"), e.get("tid"))].append(e)
    if not ranges:
        return None
    for v in ranges.values():
        v.sort(key=lambda e: e["ts"])
    starts = {k: [r["ts"] for r in v] for k, v in ranges.items()}
    gemm_corr = {k.get("args", {}).get("correlation") for k in t.device if KERNEL in k["name"] and t.in_window(k)}
    hit = set()
    for e in t.events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or corr is None or corr not in gemm_corr:
            continue
        key = (e.get("pid"), e.get("tid"))
        rs = ranges.get(key, [])
        i = bisect.bisect_right(starts.get(key, []), e["ts"])
        for r in reversed(rs[max(0, i - 8) : i]):
            if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]:
                hit.add(id(r))
                break
    calls = sum(len(v) for v in ranges.values())
    return 100.0 * len(hit) / calls
