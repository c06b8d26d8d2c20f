"""Per-layer metric ``idle_drain.serve``: the share of the traced window, in %, that
the card idled while the serve loop thread was inside ``btia.serve.drain``
(copying a batch's results to the host; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "serve", "btia.serve.drain")
