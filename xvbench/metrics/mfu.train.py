"""The training step's share of the card's peak: the model FLOPs of every
step in the window (``flops/<config>.py``, each step's shape from the
dequant's launch counter: one launch a step) over the window times the
peak of the configuration's compute type."""

from xvbench import readers

UNIT = "%"


def read(record):
    if not readers.traced(record, "train"):
        return None
    cfg, fl = record["config"], record["flops"]
    total = sum(n * fl.train_step(cfg, d, record["classes"], b, l)
                for ((b, l, d), _), n in record["launches"]["cm_dequantize"].items())
    if total <= 0:
        return None
    return 100.0 * total / (record["window_s"] * float(cfg["peak_flop_per_s"]))
