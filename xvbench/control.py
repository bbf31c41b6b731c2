"""Readings that set a cell's limits: the numbers that decide ``correct``,
read on the program, on the control and on a planted fault, over many
seeds at the cell's own size. The benchmark's runs do not run this.

    python3 xvbench/control.py --workload <cell> --seeds 1,2,3 \
        --variants program,control,half_batch

- ``program``: the program as the run drives it, up to its checked steps.
- ``control``: the reference in the program's place, in the precision
  just below the configuration's: float8 (e4m3, per-tensor scale) for
  bfloat16, TF32 for float32 (``reference/common.py``).
- ``nudged``: the reference from weights nudged by 1e-7 of
  themselves in the program's place: how far rounding alone moves the
  steps.
- ``half_batch``: the program's step trains on the first half
  of each batch, its loss the mean over that half.
- ``state_unchanged``: the step leaves every parameter as it
  was; this reads 1 by construction and needs no run on the card.

Each reading is printed as one JSON line: cell, seed, variant, numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xvbench import harness  # noqa: E402


@contextlib.contextmanager
def fault(name: str):
    """Plant a fault in the trainer for the duration: ``half_batch`` or
    ``state_unchanged``."""
    from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer

    saved = []

    def patch(cls, attr, fn):
        saved.append((cls, attr, getattr(cls, attr)))
        setattr(cls, attr, fn)

    if name == "half_batch":
        step = Trainer.train_step

        def half(self, features, labels, lr, aux_features=None):
            b = features.shape[0] // 2
            return step(self, features[:b], labels[:b], lr, aux_features)

        patch(Trainer, "train_step", half)
    elif name == "state_unchanged":
        def unchanged(self, total, lr, frozen_stats):
            self.step += 1

        patch(Trainer, "_update", unchanged)
    elif name not in ("program", "control", "nudged"):
        raise ValueError("unknown variant %r" % name)
    try:
        yield
    finally:
        for cls, attr, fn in reversed(saved):
            setattr(cls, attr, fn)


def reading(cell: str, seed: int, variant: str, device, overrides=None) -> dict:
    """The numbers of one variant on one seed: the driver's set-up up to
    its checked steps (the reference's variants need only the corpus and
    the weights), then its check."""
    _, config, traffic, driver, _ = harness.cell_files(cell, overrides)
    workdir = tempfile.mkdtemp(prefix="xvbench-control-")
    try:
        ctx = SimpleNamespace(config=config, traffic=traffic, seed=int(seed), device=device,
                              workdir=workdir)
        run = driver.Driver(ctx)
        with fault(variant):
            run.prepare()
            if variant not in ("control", "nudged"):
                run.checked_steps()
        return run.check(variant if variant in ("control", "nudged") else "program")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default="program,control")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("xvbench.control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            t0 = time.perf_counter()
            numbers = reading(args.workload, seed, variant, device)
            print(json.dumps({"cell": args.workload, "seed": seed, "variant": variant,
                              "numbers": numbers, "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
