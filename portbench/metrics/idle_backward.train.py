"""Per-layer metric ``idle_backward.train``: the share of the traced window, in %, that
the card idled while the train loop thread was inside ``btia.train.backward``
(in ``loss.backward()``; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "train", "btia.train.backward")
