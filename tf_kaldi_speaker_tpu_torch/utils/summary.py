"""Training observability: scalar summaries, profiler traces and spans.

Counterpart of ``tf_kaldi_speaker_tpu/utils/summary.py`` (replacing the
reference's TensorBoard summary plumbing, trainer.py:360-376, 424-433, and
misc/utils.py:333-346's activation histograms):

- :class:`SummaryWriter`: scalar summaries in two formats per step, an
  append-only JSONL log (``<model>/events.jsonl``) and a TensorBoard
  ``events.out.tfevents.*`` file (``utils/tb_events.py``), plus histograms
  into the latter. Records are the JAX package's.
- :func:`start_trace` / :func:`stop_trace`: ``torch.profiler`` over the
  host and, on a CUDA device, the card, saved as a Chrome trace
  (``chrome://tracing``, Perfetto) under the log dir; the JAX package
  writes a ``jax.profiler`` trace there.
- :func:`span`: a named range of the program's host work that records only
  while a ``torch.profiler`` records: a host range in the profiler's
  timeline, on its clock, and a row of an in-memory table by name
  (:func:`span_table`).
- :func:`activation_summaries`: mean, standard deviation and share of
  zeros of every floating endpoint, as 0-d tensors on the endpoints'
  device.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
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


# True while a torch.profiler records (``with profile()`` or ``prof.start()``)
_profiling = torch._C._autograd._profiler_enabled
_span_lock = threading.Lock()
_spans: Dict[str, Dict[str, int]] = {}


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open spans: a _Span, or None where not recorded


_open = _OpenSpans()


class _Unrecorded:
    """A span entered with no profiler recording, or inside such a span."""

    __slots__ = ()

    def __enter__(self):
        _open.stack.append(None)

    def __exit__(self, kind, value, tb):
        _open.stack.pop()


_UNRECORDED = _Unrecorded()


class _Span:
    __slots__ = ("name", "device", "rf", "t0", "child_ns")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self.child_ns = 0

    def __enter__(self):
        # A host op's range, not record_function's user annotation: the
        # CUDA profiler mirrors an annotation onto the device's timeline,
        # where it would read as device time.
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        _open.stack.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, kind, value, tb):
        total = time.perf_counter_ns() - self.t0
        stack = _open.stack
        stack.pop()
        self.rf.__exit__(None, None, None)
        if stack and stack[-1] is not None:
            stack[-1].child_ns += total
        drained = None if self.device is None else torch.cuda.current_stream(self.device).query()
        with _span_lock:
            row = _spans.get(self.name)
            if row is None:
                row = _spans[self.name] = dict(count=0, total_ns=0, self_ns=0, polled=0,
                                               drained=0)
            row["count"] += 1
            row["total_ns"] += total
            row["self_ns"] += total - self.child_ns
            if drained is not None:
                row["polled"] += 1
                row["drained"] += int(drained)


def span(name: str, device=None):
    """A context manager over a range of host work named ``name``.

    It records only while a ``torch.profiler`` records in this thread (the
    one that started it), and only where the span it opens inside records
    too, so a group that was open when the profiler started is left out
    whole; otherwise it costs a check of the profiler's state and this
    thread's stack of open spans. Recorded, it is a host range in the
    profiler's timeline, on the clock of the device's events, and at its
    exit it adds to :func:`span_table`'s row ``name``: ``count``,
    ``total_ns`` (host ``perf_counter_ns``), ``self_ns`` (total less the
    spans opened inside it) and, for a CUDA ``device``, ``polled`` and
    ``drained``: the exits that asked the current stream, and those that
    found it with no queued work (a non-blocking query). The table is the
    process's: it sums every profiled range since the last
    :func:`reset_spans`."""
    if not _profiling():
        return _UNRECORDED
    stack = _open.stack
    if stack and stack[-1] is None:
        return _UNRECORDED
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _Span(name, device)


def span_table() -> Dict[str, Dict[str, int]]:
    """A copy of the recorded spans' table, by name."""
    with _span_lock:
        return {name: dict(row) for name, row in _spans.items()}


def reset_spans() -> None:
    """Clear the spans' table."""
    with _span_lock:
        _spans.clear()


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
