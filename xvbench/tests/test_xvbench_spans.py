"""The span metrics (``metrics/*.train.py`` through ``spans.py``) in a
traced tiny run of the pool cell on the CPU: the four host metrics have
values, the drained share has none off a card, and the port's span table
holds the window's steps, K to a group, with the parts adding up to the
groups."""

import pytest
import torch

from xvbench import harness
from xvbench.tests import tiny

summary = pytest.importorskip("tf_kaldi_speaker_tpu_torch.utils.summary")

CELL = "tdnn_pool_train_b256"
HOST_METRICS = {"pool_sample_ms.train", "dispatch_ms_per_step.train", "host_sync_ms.train",
                "group_self_ms.train"}


@pytest.fixture(autouse=True)
def clean_table():
    # the table is the process's: rows of an earlier profiled run would add up
    summary.reset_spans()
    yield
    summary.reset_spans()


def test_traced_run_reads_the_spans():
    out = harness.run_cell(CELL, 2 ** 31 + 7, 0.5, True, torch.device("cpu"), 0.0,
                           tiny.overrides(CELL, compute_dtype="float32"))
    table = summary.span_table()
    assert out["correct"] is True
    assert HOST_METRICS <= set(out["metrics"])
    assert "sample_drained_pct.train" not in out["metrics"]
    steps = out["attempted"] // 8  # the tiny traffic's 8 chunks a step
    assert table["train.step"]["count"] == steps > 0
    assert table["train.group"]["count"] * 8 == steps  # K = 8
    assert table["pool.sample_group"]["count"] == table["train.group"]["count"]
    group = table["train.group"]
    assert group["total_ns"] == group["self_ns"] + sum(
        table[k]["total_ns"] for k in ("pool.sample_group", "train.step", "train.sync")
        if k in table)

