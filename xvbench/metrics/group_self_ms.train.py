"""The host's time a training group outside its sampling, steps and syncs
(the triples' upload, the K gathers' launches, the generator, the stop
poll): the ``train.group`` spans' self time over their count."""

from xvbench import spans

UNIT = "ms"


def read(record):
    return spans.ms_per(record, "train", "train.group", "self_ns", "train.group")
