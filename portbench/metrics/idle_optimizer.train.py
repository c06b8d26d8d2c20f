"""Per-layer metric ``idle_optimizer.train``: the share of the traced window, in %, that
the card idled while the train loop thread was inside ``btia.train.optimizer``
(clipping, AdamW and clearing the gradients; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "train", "btia.train.optimizer")
