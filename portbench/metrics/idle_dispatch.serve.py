"""Per-layer metric ``idle_dispatch.serve``: the share of the traced window, in %, that
the card idled while the serve loop thread was inside ``btia.serve.dispatch``
(stacking, packing and launching a batch; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "serve", "btia.serve.dispatch")
