"""Per-layer metric ``mla_kernel_share.serve``: the share, in %, of the
traced window's ``btia.lm.attn`` spans (a latent attention of
``models/mla_moe.py``) inside which the packed-token attention kernel
(``mla_attn_kernel``, ``csrc/mla_attn.cu``) launched: the layers whose
attention core ran as that one kernel. A kernel is attributed through its
launch's correlation id to the innermost such span open on the launching
thread at the launch. A program without the spans reads nothing; one
without the kernel reads 0."""

import bisect
from collections import defaultdict

KERNEL = "mla_attn_kernel"
SPAN = "btia.lm.attn"


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.has_device:
        return None
    spans = defaultdict(list)
    for e in t.events:
        if e.get("cat") == "user_annotation" and e["name"] == SPAN and t.in_window(e):
            spans[(e.get("pid"), e.get("tid"))].append(e)
    if not spans:
        return None
    for v in spans.values():
        v.sort(key=lambda e: e["ts"])
    starts = {k: [r["ts"] for r in v] for k, v in spans.items()}
    corr = {k.get("args", {}).get("correlation") for k in t.device if KERNEL in k["name"] and t.in_window(k)}
    hit = set()
    for e in t.events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or c is None or c not in corr:
            continue
        key = (e.get("pid"), e.get("tid"))
        rs = spans.get(key, [])
        i = bisect.bisect_right(starts.get(key, []), e["ts"])
        for r in reversed(rs[max(0, i - 8) : i]):
            if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]:
                hit.add(id(r))
                break
    return 100.0 * len(hit) / sum(len(v) for v in spans.values())
