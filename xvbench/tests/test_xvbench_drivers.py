"""Each driver end to end at a tiny width on the CPU, with the kernels'
plain versions: a well-formed result, rates taken as all the work over
all the window, no JAX in the process, and no result without a card."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import pytest
import torch

from xvbench import harness
from xvbench.tests import tiny

CELLS = sorted(tiny.CELLS)
RATES = {"tdnn_pool_train_b256": "train_chunks_per_s"}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_gives_a_well_formed_result(cell, trace):
    # float32: at this width bf16's rounding alone reads past the limits
    out = harness.run_cell(cell, 2 ** 31 + 5, 0.5, bool(trace), torch.device("cpu"), 0.0,
                           tiny.overrides(cell, compute_dtype="float32"))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    if trace:
        assert out["device"]["window_s"] > 0 and "breakdown" in out
        assert RATES[cell] not in out["metrics"]
    else:
        assert set(out["metrics"]) == {RATES[cell], "setup_s"}
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_rate_is_all_the_work_over_the_whole_window(cell, tmp_path):
    """The driver's rate is the window's whole work over its whole time,
    whatever the window's length."""
    _, config, traffic, driver, _ = harness.cell_files(cell, tiny.overrides(cell))
    ctx = SimpleNamespace(config=config, traffic=traffic, seed=3, workdir=str(tmp_path),
                          device=torch.device("cpu"))
    run = driver.Driver(ctx)
    run.setup()
    marks = []

    def mark():
        marks.append(time.perf_counter())
        return marks[-1]

    window = run.window(0.3, mark)
    assert len(marks) == 1
    rate, unit = window["end_to_end"][RATES[cell]]
    assert window["chunks"] == window["steps"] * 8 and unit == "chunks/s"
    assert rate == pytest.approx(window["chunks"] / window["window_s"])
    assert window["window_s"] >= 0.3


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(["tf_kaldi_speaker_tpu_torch.ops", "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jax.numpy", "tf_kaldi_speaker_tpu.data", "flax"]) == [
        "flax", "jax", "tf_kaldi_speaker_tpu"]


def test_a_run_loads_no_jax():
    """A whole run (both cells, traced) in a fresh process, then its
    modules by whole top-level name."""
    code = textwrap.dedent("""
        import json, sys, torch
        sys.path.insert(0, %r)
        from xvbench import harness
        from xvbench.tests import tiny
        for cell in %r:
            harness.run_cell(cell, 9, 0.3, True, torch.device("cpu"), 0.0, tiny.overrides(cell))
        print(json.dumps(harness.forbidden_modules()))
    """) % (harness.ROOT, CELLS)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT, env=env)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == []
    own = [m for m in sys.modules if m.split(".")[0] == "xvbench"]
    assert own  # this process imported the harness; nothing of it imported JAX above


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints
    nothing on standard output."""
    got = subprocess.run([sys.executable, "xvbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=harness.ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert got.returncode != 0 and got.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and xvbench/ (no port),
    the command exits non-zero and prints nothing on standard output."""
    shutil.copytree(harness.HERE, tmp_path / "xvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    got = subprocess.run([sys.executable, "xvbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert got.returncode != 0 and got.stdout == ""
    assert "tf_kaldi_speaker_tpu_torch" in got.stderr
