"""Per-layer metric ``peak_mem_gib.train``."""


def read(ctx):
    """torch.cuda.max_memory_allocated at the window's end, GiB."""
    b = ctx.get("memory_peak_bytes")
    return b / 2**30 if ctx.get("kind") == "train" and b else None
