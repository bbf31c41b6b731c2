"""What the per-layer metrics under ``metrics/`` share: each metric file
names its driver, and the op, kernel or events it sums over, and calls one
of these. A reader that finds nothing to read returns None, and the
harness leaves that metric out of the line.
"""

from __future__ import annotations

from xvbench import costs


def traced(record, driver: str) -> bool:
    return record.get("driver") == driver and "trace" in record


def roofline_pct(record, driver: str, op: str, kernel: str, cost) -> "float | None":
    """100 x the summed bound of ``op``'s launches in the window (bytes and
    operations from each launch's shape) over the summed device time of
    the kernels whose names hold ``kernel``."""
    if not traced(record, driver):
        return None
    bound = sum(n * costs.bound_s(*cost(b, l, d, costs.ELEMENT_BYTES[dtype]))
                for ((b, l, d), dtype), n in record["launches"][op].items())
    spent = sum(s for name, s in record["trace"]["kernel_s"].items() if kernel in name)
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent


def idle_pct(record, driver: str) -> "float | None":
    """100 x the share of the window in which no operation ran on the
    device."""
    if not traced(record, driver) or record["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["trace"]["busy_s"] / record["window_s"])
