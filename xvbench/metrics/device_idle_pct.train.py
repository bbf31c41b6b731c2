"""Share of the training window in which no operation ran on the card
(1 - the union of the device events' spans / the window)."""

from xvbench import readers

UNIT = "%"


def read(record):
    return readers.idle_pct(record, "train")
