"""Device time of the train-mode BatchNorm a training step: the kernels
whose names hold ``bn_train_`` (``ops/batchnorm.py`` over
``csrc/batchnorm.cu``: the statistics and their finish, the normalize
pass, the backward's sums and their finish, and its dx pass) in the
window's trace over the steps the window trained. Nothing to read where
none ran: a program without these kernels, or one whose BatchNorms kept
the plain path."""

from xvbench import readers

UNIT = "ms"
KERNELS = "bn_train_"


def read(record):
    if not readers.traced(record, "train") or not record["steps"]:
        return None
    spent = sum(s for name, s in record["trace"]["kernel_s"].items() if KERNELS in name)
    return 1e3 * spent / record["steps"] if spent > 0 else None
