"""The host's time blocked on reads of device values a training group
(the progress line, summaries, the numerics check): the ``train.sync``
spans over the window's ``train.group`` spans."""

from xvbench import spans

UNIT = "ms"


def read(record):
    return spans.ms_per(record, "train", "train.sync", "total_ns", "train.group")
