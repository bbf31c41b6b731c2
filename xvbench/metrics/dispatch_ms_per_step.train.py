"""The host's time enqueuing one training step (dequant, forward,
backward, update): the mean ``train.step`` span of the window."""

from xvbench import spans

UNIT = "ms"


def read(record):
    return spans.ms_per(record, "train", "train.step", "total_ns", "train.step")
