"""Per-layer metric ``data_wait_ms.train``."""


def read(ctx):
    """Host ms a step blocked on the Trainer's data iterator in the traced
    run's window before the profiler started."""
    return ctx.get("data_wait_ms") if ctx.get("kind") == "train" else None
