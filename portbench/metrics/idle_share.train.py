"""Per-layer metric ``idle_share.train``: the device's idle share of the
traced window, 1 - (union of kernel, memcpy and memset intervals) / window."""


def read(ctx):
    t = ctx.get("trace")
    return t.idle_share() if t is not None else None
