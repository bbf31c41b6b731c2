"""The check catches what it is for. A whole run at a tiny width on the CPU,
with the cell's own limits, comes out correct for the sound program and
not correct with each fault the cell can have planted underneath the
timed path; the control (the reference in the precision below the
configuration's, in the program's place) fails the cell's limits too.
The configuration runs in float32 here, so the sound program sits far
inside the limits at this width."""

import pytest
import torch

from xvbench import control, harness
from xvbench.tests import tiny

FAULTS = [("tdnn_pool_train_b256", "state_unchanged"), ("tdnn_pool_train_b256", "half_batch")]


def _run(cell, variant, seed=2 ** 31 + 77):
    with control.fault(variant):
        return harness.run_cell(cell, seed, 0.3, False, torch.device("cpu"), 0.0,
                                tiny.overrides(cell, compute_dtype="float32"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_program_is_correct(cell):
    assert _run(cell, "program")["correct"] is True


@pytest.mark.parametrize("cell,variant", FAULTS)
def test_fault_is_not_correct(cell, variant):
    out = _run(cell, variant)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_fails_a_limit(cell):
    limits = harness.load_json("workloads", cell + ".json")["limits"]
    numbers = control.reading(cell, 2 ** 31 + 78, "control", torch.device("cpu"),
                              tiny.overrides(cell))
    assert any(numbers[k] > limits[k] for k in limits), numbers
