"""Per-layer metric ``idle_wait.serve``: the share of the traced window, in %, that
the card idled while the serve loop thread was inside ``btia.serve.wait``
(blocked on the decode queue; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "serve", "btia.serve.wait")
