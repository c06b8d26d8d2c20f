"""Per-layer metric ``idle_data.train``: the share of the traced window, in %, that
the card idled while the train loop thread was inside ``btia.data.wait``
(waiting for the data iterator's next batch; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "train", "btia.data.wait")
