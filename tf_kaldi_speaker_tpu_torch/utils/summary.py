"""Training observability: scalar summaries and profiler traces.

Counterpart of ``tf_kaldi_speaker_tpu/utils/summary.py`` (replacing the
reference's TensorBoard summary plumbing, trainer.py:360-376, 424-433, and
misc/utils.py:333-346's activation histograms):

- :class:`SummaryWriter`: scalar summaries in two formats per step, an
  append-only JSONL log (``<model>/events.jsonl``) and a TensorBoard
  ``events.out.tfevents.*`` file (``utils/tb_events.py``), plus histograms
  into the latter. Records are the JAX package's.
- :func:`start_trace` / :func:`stop_trace` / :func:`profile_trace`:
  ``torch.profiler`` over the host and, on a CUDA device, the card, saved
  as a Chrome trace (``chrome://tracing``, Perfetto) under the log dir;
  the JAX package writes a ``jax.profiler`` trace there.
- :func:`activation_summaries`: mean, standard deviation and share of
  zeros of every floating endpoint, as 0-d tensors on the endpoints'
  device.
"""

from __future__ import annotations

import json
import os
import socket
import time
from contextlib import contextmanager
from typing import Dict

import numpy as np
import torch

from .tb_events import TBEventWriter


class SummaryWriter:
    def __init__(self, logdir: str, filename: str = "events.jsonl",
                 tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._fp = open(self.path, "a")
        self._tb = TBEventWriter(logdir) if tensorboard else None
        self._t0 = time.time()

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        for k, v in values.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._fp.write(json.dumps(rec) + "\n")
        self._fp.flush()
        if self._tb is not None:
            tags = {k: v for k, v in rec.items() if k not in ("step", "wall")}
            self._tb.scalars(step, tags)

    def histograms(self, step: int, tensors: Dict[str, "np.ndarray"]) -> None:
        """Variable/activation histograms into the tfevents stream
        (reference trainer.py:431-432, misc/utils.py:333-346)."""
        if self._tb is not None:
            self._tb.histograms(step, tensors)

    def close(self) -> None:
        self._fp.close()
        if self._tb is not None:
            self._tb.close()


def load_scalars(path: str):
    """Read back an events.jsonl into {tag: [(step, value)]}."""
    out: Dict[str, list] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            step = rec.pop("step")
            rec.pop("wall", None)
            for k, v in rec.items():
                out.setdefault(k, []).append((step, v))
    return out


def start_trace(device) -> torch.profiler.profile:
    """Start a ``torch.profiler`` trace of the host and, for a CUDA device,
    the card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, logdir: str) -> str:
    """Stop ``prof`` and save it as a Chrome trace under ``logdir``
    (``<host>.<pid>.<ns>.pt.trace.json``); returns the file's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "%s.%d.%d.pt.trace.json" % (
        socket.gethostname(), os.getpid(), time.time_ns()))
    prof.export_chrome_trace(path)
    return path


@contextmanager
def profile_trace(logdir: str, device="cuda"):
    """Profiler trace context; the trace lands under ``logdir``."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        stop_trace(prof, logdir)


def activation_summaries(endpoints: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-endpoint activation stats (misc/utils.py:333-346 equivalent)."""
    out = {}
    for name, x in endpoints.items():
        if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.dim() == 0:
            continue
        xf = x.detach().to(torch.float32)
        out[name + "/mean"] = torch.mean(xf)
        out[name + "/std"] = torch.std(xf, unbiased=False)
        out[name + "/zero_frac"] = torch.mean((xf == 0).to(torch.float32))
    return out
