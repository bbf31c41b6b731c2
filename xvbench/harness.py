"""The benchmark's harness: one run of one cell.

``python3 xvbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. The harness finds everything
by name: the cell in ``workloads/<cell>.json`` (its configuration, its
traffic mix, its chips and the limits of its check), the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``
(which names its driver, ``drivers/<driver>.py``), the model's FLOP
arithmetic in ``flops/<config>.py`` and the per-layer metrics in
``metrics/<metric>.py``. A later cell, configuration or metric is a new
file; no file here changes for it.

A run: the set-up (the traffic driver's corpus, model and warm-up of
every shape the cell's traffic uses), a window of ``--seconds`` that the
traffic driver starts by calling ``mark`` with the device idle and ends
at a device synchronisation, the peak memory, then the traffic driver's
comparison against the plain reference, outside the window. ``setup_s`` is every second from the
process's start to the window's. With ``--trace 1`` a torch.profiler (CPU
and CUDA) records the window and the line carries the per-layer metrics
that the cell's readers find, with a breakdown; with ``--trace 0`` the
end-to-end metrics. The last line of standard output is one JSON
object; the numbers compared and their limits are the last lines of
standard error and the last key of that object.
"""

from __future__ import annotations

import argparse
import collections
import gc
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Whole top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "tf_kaldi_speaker_tpu")
# The port's launch-shape counters: (module, function) by op name.
COUNTERS = {
    "cm_dequantize": ("tf_kaldi_speaker_tpu_torch.ops.cm_dequant", "cm_dequantize"),
    "masked_stats_pooling": ("tf_kaldi_speaker_tpu_torch.ops.pooling", "masked_stats_pooling"),
    "masked_stats_pooling_backward": ("tf_kaldi_speaker_tpu_torch.ops.pooling",
                                      "masked_stats_pooling_backward"),
}


def load_json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(cell: str, overrides: Optional[Dict] = None):
    """(cell, config, traffic, driver module, flops module) of a cell;
    ``overrides`` (the tests' small sizes) update the configuration's keys
    and the traffic's, a block of the traffic key by key."""
    overrides = overrides or {}
    spec = load_json("workloads", cell + ".json")
    config = dict(load_json("configs", spec["config"] + ".json"), **overrides.get("config", {}))
    traffic = load_json("traffic", spec["traffic"] + ".json")
    for key, value in overrides.get("traffic", {}).items():
        traffic[key] = dict(traffic[key], **value) if isinstance(value, dict) else value
    driver = load_module(os.path.join(HERE, "drivers", traffic["driver"] + ".py"),
                         "xvbench_driver_" + traffic["driver"])
    flops = load_module(os.path.join(HERE, "flops", spec["config"] + ".py"),
                        "xvbench_flops_" + spec["config"])
    return spec, config, traffic, driver, flops


def metric_readers():
    """{metric name: reader module} of every file under metrics/."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        out[name] = load_module(path, "xvbench_metric_" + name.replace(".", "_"))
    return out


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``tf_kaldi_speaker_tpu_torch`` is not
    ``tf_kaldi_speaker_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def launch_counts() -> Dict[str, collections.Counter]:
    """A copy of each port op's launches by ((B, L, D), dtype)."""
    out = {}
    for op, (mod, fn) in COUNTERS.items():
        out[op] = collections.Counter(getattr(sys.modules[mod], fn).shapes)
    return out


class Tracer:
    """torch.profiler (CPU and, on a card, CUDA) from :meth:`start` to
    :meth:`stop`, or nothing."""

    def __init__(self, torch, on: bool, device):
        self.on = on
        self.prof = None
        if on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._make = lambda: profile(activities=acts)
            # the profiler's first start initialises its tracer: do it in set-up
            with self._make():
                torch.zeros(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize()

    def start(self):
        if self.on and self.prof is None:
            self.prof = self._make()
            self.prof.start()

    def stop(self):
        if self.prof is not None:
            self.prof.stop()


def read_trace(prof) -> Dict:
    """Device spans, kernel time by name, host runtime calls by name and
    the longest idle gaps from the profiler's raw events. A gap is named by
    the innermost host op running at its middle, or as Python where no
    torch op or CUDA call runs there."""
    dev_start, dev_end, dev_name = [], [], []
    cpu_start, cpu_end, cpu_name = [], [], []
    runtime = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            dev_start.append(e.start_ns())
            dev_end.append(e.end_ns())
            dev_name.append(e.name())
        else:
            name = e.name()
            if name.startswith("cu"):  # CUDA runtime and driver calls
                runtime[name] += 1
            cpu_start.append(e.start_ns())
            cpu_end.append(e.end_ns())
            cpu_name.append(name)
    by_name = collections.Counter()
    for s, t, n in zip(dev_start, dev_end, dev_name):
        by_name[n] += (t - s) * 1e-9
    spans = sorted(zip(dev_start, dev_end))
    busy, gaps, end = 0, [], None
    for s, t in spans:
        if end is None:
            busy += t - s
            end = t
        elif t > end:
            if s > end:
                gaps.append((s - end, end, s))
            busy += t - max(s, end)
            end = t
    gaps.sort(reverse=True)
    cs, ce = np.asarray(cpu_start, np.int64), np.asarray(cpu_end, np.int64)
    named = []
    for length, a, b in gaps[:10]:
        mid = (a + b) // 2
        inside = np.nonzero((cs <= mid) & (ce >= mid))[0]
        if inside.size:
            name = cpu_name[int(inside[np.argmin(ce[inside] - cs[inside])])]
        else:
            name = "host: Python, no torch op"
        named.append([name, length * 1e-9])
    return {"busy_s": busy * 1e-9, "kernel_s": by_name, "runtime": runtime, "gaps": named,
            "events": len(dev_name) + len(cpu_name)}


def card_name() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return "nvidia-smi not read (%s)" % e
    return "; ".join(got.stdout.strip().splitlines()) or "nvidia-smi printed nothing"


def device_info(torch, device, chips: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             overrides: Optional[Dict] = None) -> Dict:
    """One run of ``cell`` on ``device``: returns the result object (the
    numbers compared under ``checks``). ``overrides`` (tests) update the
    configuration's and the traffic's keys."""
    import torch

    spec, config, traffic, driver, flops = cell_files(cell, overrides)
    workdir = tempfile.mkdtemp(prefix="xvbench-")
    try:
        ctx = SimpleNamespace(config=config, traffic=traffic, seed=int(seed), device=device,
                              workdir=workdir)
        run = driver.Driver(ctx)
        run.setup()
        tracer = Tracer(torch, trace, device)
        start = {}

        def mark() -> float:
            """The window starts: the driver calls this once, the device idle."""
            start["launches"] = launch_counts()
            tracer.start()
            start["t0"] = time.perf_counter()
            return start["t0"]

        try:
            window = run.window(float(seconds), mark)
        finally:
            tracer.stop()
        after = launch_counts()
        setup_s = start["t0"] - t_start
        dev = device_info(torch, device, int(spec["chips"]))
        found = forbidden_modules()
        if found:
            raise SystemExit("loaded in the run's process: %s" % ", ".join(found))
        record = dict(window, driver=traffic["driver"], config=config, traffic=traffic,
                      flops=flops,
                      launches={op: after[op] - start["launches"][op] for op in after})
        out = {"correct": None, "attempted": window["attempted"], "failed": window["failed"],
               "metrics": {}, "device": dev}
        if trace:
            t_read = time.perf_counter()
            tr = read_trace(tracer.prof)
            print("xvbench: the trace's %d events read in %.1f s" % (
                tr["events"], time.perf_counter() - t_read), file=sys.stderr)
            record["trace"] = tr
            dev["busy_s"] = tr["busy_s"]
            dev["window_s"] = window["window_s"]
            for name, reader in metric_readers().items():
                value = reader.read(record)
                if value is not None:
                    out["metrics"][name] = {"value": float(value), "unit": reader.UNIT}
            out["breakdown"] = {"device_ops": [[n, s] for n, s in tr["kernel_s"].most_common(10)],
                                "idle_gaps": tr["gaps"]}
            tracer.prof = None
        else:
            for name, (value, unit) in window["end_to_end"].items():
                out["metrics"][name] = {"value": float(value), "unit": unit}
            out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        gc.collect()
        numbers = run.check()
        limits = spec["limits"]
        for k in sorted(set(numbers) - set(limits)):
            print("xvbench: %s %.6g (not compared: no limit)" % (k, numbers[k]), file=sys.stderr)
        checks = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
        out["correct"] = bool(all(c["value"] <= c["limit"] for c in checks.values())
                              and out["failed"] == 0)
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json("workloads", args.workload + ".json")
    importlib.import_module("tf_kaldi_speaker_tpu_torch")  # the program under test
    # every build and kernel cache at a fixed path inside the checkout
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    import torch

    chips = int(spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("xvbench: the cell needs %d CUDA device(s); torch sees %s" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else "none"),
            file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("xvbench: TF32 off (matmul %s, cudnn %s)" % (
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32), file=sys.stderr)
    print("xvbench: %s; peaks: HBM 3.35 TB/s, bf16 989 TFLOP/s, float32 67 TFLOP/s (H100 SXM "
          "data sheet)" % card_name(), file=sys.stderr)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    for name, c in out["checks"].items():
        print("check %s %.6g limit %.6g" % (name, c["value"], c["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0
