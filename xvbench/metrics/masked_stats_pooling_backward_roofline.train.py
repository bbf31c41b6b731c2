"""The pooling backward's share of its roofline in the training window: op
``masked_stats_pooling_backward`` (ops/pooling.py), kernel
``stats_pooling_bwd_kernel`` (csrc/stats_pooling_bwd.cu)."""

from xvbench import costs, readers

UNIT = "%"


def read(record):
    return readers.roofline_pct(record, "train", "masked_stats_pooling_backward",
                                "stats_pooling_bwd_kernel", costs.pooling_bwd_cost)
