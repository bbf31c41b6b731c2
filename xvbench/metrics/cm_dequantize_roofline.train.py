"""The dequant's share of its roofline in the training window: op
``cm_dequantize`` (ops/cm_dequant.py), kernel ``cm_dequantize_kernel``
(csrc/cm_dequant.cu)."""

from xvbench import costs, readers

UNIT = "%"


def read(record):
    return readers.roofline_pct(record, "train", "cm_dequantize", "cm_dequantize_kernel",
                                costs.dequant_cost)
