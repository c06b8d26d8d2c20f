"""Per-layer metric ``step_mfu.train``."""


def read(ctx):
    """Model FLOPs of the examples stepped (3 x forward) in the traced run's
    window before the profiler started / those seconds / the bf16 peak, in %."""
    if ctx.get("kind") != "train" or "trace" not in ctx or not ctx["trace"].has_device:
        return None
    if ctx.get("mfu_seconds", 0) <= 0:
        return None
    return 100.0 * ctx["mfu_flops"] / ctx["mfu_seconds"] / ctx["peak_flops"]
