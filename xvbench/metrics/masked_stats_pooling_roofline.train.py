"""The pooling forward's share of its roofline in the training window: op
``masked_stats_pooling`` (ops/pooling.py), kernel ``stats_pooling_kernel``
(csrc/stats_pooling.cu)."""

from xvbench import costs, readers

UNIT = "%"


def read(record):
    return readers.roofline_pct(record, "train", "masked_stats_pooling", "stats_pooling_kernel",
                                costs.pooling_cost)
