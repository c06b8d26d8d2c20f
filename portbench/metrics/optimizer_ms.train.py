"""Per-layer metric ``optimizer_ms.train``: device ms a step of the kernels
launched inside the program's ``btia.train.optimizer|<step>`` spans
(clipping, AdamW, clearing the gradients), summed over the traced window
and divided by the count of those spans (one an optimizer step)."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or not t.has_device:
        return None
    times = t.range_device_time("btia.train.optimizer|")
    steps = sum(v for k, v in times.items() if k.startswith("#"))
    if not steps:
        return None
    return 1e3 * sum(v for k, v in times.items() if not k.startswith("#")) / steps
