"""``bn_train_ms_per_step.train`` on synthetic records: the BatchNorm
kernels' device time over the window's steps, and nothing where they did
not run (the parent program, the plain path, an untraced run)."""

import collections

import pytest

from xvbench import harness

READER = harness.metric_readers()["bn_train_ms_per_step.train"]
# the names the profiler gives the kernels' instantiations
STATS = "void (anonymous namespace)::bn_train_stats_kernel<__nv_bfloat16, 8, true>(...)"
GRAD = "void (anonymous namespace)::bn_train_grad_kernel<__nv_bfloat16, 4, false>(...)"


def _record(kernel_s, steps=40, driver="train"):
    return {"driver": driver, "steps": steps,
            "trace": {"kernel_s": collections.Counter(kernel_s), "busy_s": 1.0,
                      "runtime": collections.Counter(), "gaps": []}}


def test_sums_the_kernels_over_the_steps():
    rec = _record({STATS: 0.02, GRAD: 0.06, "stats_pooling_kernel<float>": 5.0,
                   "elementwise_kernel<128, 2>": 3.0})
    assert READER.read(rec) == pytest.approx(1e3 * 0.08 / 40)


@pytest.mark.parametrize("rec", [
    _record({"elementwise_kernel<128, 2>": 3.0}),             # the plain path: no kernel
    _record({STATS: 0.02}, steps=0),                          # no step trained
    _record({STATS: 0.02}, driver="extract"),                 # another driver's window
    {"driver": "train", "steps": 40}])                        # untraced
def test_nothing_to_read(rec):
    assert READER.read(rec) is None
