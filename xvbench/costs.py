"""The frozen arithmetic of the port's kernels: the bytes and operations of
each op from its launch shape, and the peaks of one H100 SXM (NVIDIA's
data sheet: HBM3 at 3.35 TB/s; 67 TFLOP/s float32 outside the tensor
cores, where the kernels' arithmetic runs; 989 TFLOP/s dense bf16). Copied
from ``chip_smoke.py`` (``dequant_cost``, ``pooling_cost``,
``pooling_bwd_cost``, ``bound_ms``), which ``tests/test_xvbench_frozen.py``
holds equal.

An op's work is counted from its launch shape, not from the kernel that
does it, so a later kernel for the same op is read against the same
bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def dequant_cost(b, l, d, esize=None):
    """Bytes (codes read, headers read, f32 out written) and operations (a
    multiply and an add per element) of cm_dequantize at [b, l, d]."""
    return b * l * d * (1 + 4) + b * 4 * d * 4, 2 * b * l * d


def pooling_cost(b, l, d, esize):
    """Bytes (x and the f32 mask read, [b, 2d] written) and operations (a
    subtract, a multiply and two multiply-adds per element) of the pooling."""
    return b * l * d * esize + b * l * 4 + 2 * b * d * esize, 6 * b * l * d


def pooling_bwd_cost(b, l, d, esize):
    """Bytes (x, the f32 mask, out and g read, gx written) and operations (a
    subtract, a multiply-add and a multiply per element) of the pooling
    backward."""
    return 2 * b * l * d * esize + b * l * 4 + 2 * 2 * b * d * esize, 4 * b * l * d


ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "uint8": 1}
