"""Per-layer metric ``idle_deliver.serve``: the share of the traced window, in %, that
the card idled while the serve loop thread was inside ``btia.serve.deliver``
(yielding a request's answers: the caller's time; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "serve", "btia.serve.deliver")
