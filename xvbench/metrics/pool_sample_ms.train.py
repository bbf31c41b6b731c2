"""The host's time in the device pool's sampling a training group
(``DevicePool.sample_group``, data/device_pool.py): the span
``pool.sample_group`` over the window's ``train.group`` spans."""

from xvbench import spans

UNIT = "ms"


def read(record):
    return spans.ms_per(record, "train", "pool.sample_group", "total_ns", "train.group")
