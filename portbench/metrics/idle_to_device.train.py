"""Per-layer metric ``idle_to_device.train``: the share of the traced window, in %, that
the card idled while the train loop thread was inside ``btia.train.to_device``
(stacking a batch or chunk and copying it to the card; the innermost program span open, ``portbench/spans.py``)."""

from portbench import spans


def read(ctx):
    return spans.idle_pct(ctx, "train", "btia.train.to_device")
