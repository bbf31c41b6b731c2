"""What the span metrics under ``metrics/`` share: the port's table of the
spans recorded while the profiler recorded
(``tf_kaldi_speaker_tpu_torch.utils.summary.span_table``: by span name,
``count``, ``total_ns``, ``self_ns``, ``polled`` and ``drained``). A run
profiles only its window, so the table holds the window's spans. A program
without spans gives nothing to read.
"""

from __future__ import annotations

import sys

from xvbench import readers

PROGRAM = "tf_kaldi_speaker_tpu_torch.utils.summary"


def table(record, driver: str) -> "dict | None":
    """The program's span table in a traced run of ``driver``, or None."""
    if not readers.traced(record, driver):
        return None
    get = getattr(sys.modules.get(PROGRAM), "span_table", None)
    return get() if get is not None else None


def ms_per(record, driver: str, name: str, field: str, per: str) -> "float | None":
    """``field`` (``total_ns`` or ``self_ns``) of span ``name`` in ms over
    the count of span ``per``; a span never entered spent 0 ms."""
    spans = table(record, driver)
    n = spans.get(per, {}).get("count") if spans else None
    if not n:
        return None
    return spans.get(name, {}).get(field, 0) * 1e-6 / n
