"""Share of the pool's samplings that ended with the card's stream empty:
the ``pool.sample_group`` spans whose exit found no queued work on the
current CUDA stream, over those that asked (none off a card)."""

from xvbench import spans

UNIT = "%"


def read(record):
    row = (spans.table(record, "train") or {}).get("pool.sample_group")
    if not row or not row["polled"]:
        return None
    return 100.0 * row["drained"] / row["polled"]
