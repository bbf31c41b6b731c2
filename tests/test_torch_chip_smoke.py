"""chip_smoke.py without a card: its bound arithmetic, and that it exits
non-zero and prints no result where CUDA is not available, both from the
repository and alone in an empty directory."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Bytes each kernel must move: every input read once, every output written
# once (the bf16 pooling reads x and the f32 mask and writes [B, 2D] bf16;
# its backward reads x, the mask, out and g and writes gx).
@pytest.mark.parametrize("cost, shape, nbytes", [
    ("pooling", (32, 386, 1500, 2), 37_297_408),
    ("pooling", (32, 386, 1500, 4), 74_545_408),
    ("dequant", (32, 400, 30), 1_935_360),
    ("dequant", (256, 1200, 30), 46_202_880),
    ("pooling_bwd", (64, 286, 1500, 2), 110_665_216),
    ("pooling_bwd", (64, 286, 1500, 4), 221_257_216),
    ("pooling_bwd", (1, 1, 4, 2), 1 * 1 * 4 * 2 * 2 + 4 + 4 * 4 * 2),
])
def test_kernel_bytes(cost, shape, nbytes):
    cs = _chip_smoke()
    got, flops = getattr(cs, cost + "_cost")(*shape)
    assert got == nbytes
    ms, by = cs.bound_ms(got, flops)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / cs.HBM_BYTES_PER_S)


def test_bound_takes_the_larger_time():
    cs = _chip_smoke()
    assert cs.bound_ms(3.35e9, 0) == pytest.approx((1.0, "bytes"))
    ms, by = cs.bound_ms(0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_cuda(where, tmp_path):
    if where == "repo":
        cwd, script = ROOT, SCRIPT
    else:
        cwd, script = str(tmp_path), shutil.copy(SCRIPT, tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_pooling_backward_operations():
    """A subtract, a multiply-add and a multiply per element of x: four
    operations, far below the bytes at any shape."""
    cs = _chip_smoke()
    nbytes, flops = cs.pooling_bwd_cost(64, 286, 1500, 2)
    assert flops == 4 * 64 * 286 * 1500
    ms, by = cs.bound_ms(nbytes, flops)
    assert by == "bytes" and ms == pytest.approx(0.033034392835820894)


def test_training_config_is_the_flagship():
    """The training phase runs __graft_entry__.FLAGSHIP (with fused pooling)
    from the device pool, cut only in epochs and steps."""
    cs = _chip_smoke()
    extra = {k: v for k, v in cs.TRAIN.items() if k not in cs.FLAGSHIP}
    assert {k: cs.TRAIN[k] for k in cs.FLAGSHIP} == cs.FLAGSHIP
    assert extra == dict(device_pool=True, num_steps_per_epoch=16, steps_per_dispatch=8,
                         num_epochs=2, learning_rate=0.01, valid_max_iterations=2,
                         show_training_progress=8, check_numerics=True)
    assert cs.FLAGSHIP["compute_dtype"] == "bfloat16" and cs.FLAGSHIP["use_fused_pooling"]
