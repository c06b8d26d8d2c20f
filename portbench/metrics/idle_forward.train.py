"""Per-layer metric ``idle_forward.train``: the share of the traced window, in %, that
the card idled while the train loop thread was inside ``btia.train.forward``
(launching the forward and the loss; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "train", "btia.train.forward")
