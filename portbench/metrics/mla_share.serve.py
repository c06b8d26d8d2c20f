"""Per-layer metric ``mla_share.serve``: the device time of the kernels
launched inside the program's ``btia.lm.attn`` spans (a whole latent
attention of ``models/mla_moe.py``: its projections, RMSNorm, RoPE and the
attention core) over the traced window's busy device time, in %. A kernel is
attributed as ``Trace.range_device_time`` attributes it: through its
launch's correlation id to the innermost such span open on the launching
thread. A program without those spans reads nothing."""

SPAN = "btia.lm.attn"


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.has_device or t.busy_s <= 0:
        return None
    times = t.range_device_time(SPAN)
    if "#" + SPAN not in times:
        return None
    return 100.0 * times.get(SPAN, 0.0) / t.busy_s
