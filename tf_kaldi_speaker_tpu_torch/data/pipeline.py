"""Host-side prefetching: worker threads fill a bounded queue.

A copy of ``PrefetchLoader`` from ``tf_kaldi_speaker_tpu/data/pipeline.py``
(replacing the reference's multiprocessing producer queues,
dataset/data_loader.py:310-414): worker *threads* (the decode is numpy and
releases the GIL) fill a bounded queue; worker i uses seed
``base_seed + i``. The JAX package's ``device_prefetch`` has no counterpart:
the port's trainer feeds from the device pool.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

from .sampler import DataOutOfRange


class PrefetchLoader:
    """Threaded batch producer with the reference queue API (start/fetch/stop).

    Args:
        sampler_factory: ``f(worker_seed) -> iterable`` creating one sampler
            per worker (each opens its own FeatureReader fds).
        num_parallel: number of worker threads (``num_parallel_datasets``).
        max_qsize: bounded queue capacity (``max_queue_size``).
        finite: if True, fetch() raises DataOutOfRange once all workers are
            exhausted and the queue has drained (sequential/validation mode).
    """

    def __init__(
        self,
        sampler_factory: Callable[[int], object],
        num_parallel: int = 4,
        max_qsize: int = 10,
        base_seed: int = 0,
        finite: bool = False,
    ):
        self.sampler_factory = sampler_factory
        self.num_parallel = num_parallel
        self.base_seed = base_seed
        self.finite = finite
        self.queue: queue.Queue = queue.Queue(max_qsize)
        self.stop_event = threading.Event()
        self.threads = []
        self._done = 0
        self._done_lock = threading.Lock()
        self._samplers = []

    def _work(self, worker_id: int) -> None:
        sampler = self.sampler_factory(self.base_seed + worker_id)
        self._samplers.append(sampler)
        try:
            for batch in sampler:
                while not self.stop_event.is_set():
                    try:
                        self.queue.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self.stop_event.is_set():
                    return
        finally:
            with self._done_lock:
                self._done += 1

    def start(self) -> "PrefetchLoader":
        self.threads = [
            threading.Thread(target=self._work, args=(i,), daemon=True)
            for i in range(self.num_parallel)
        ]
        for t in self.threads:
            t.start()
        return self

    def fetch(self):
        while True:
            try:
                return self.queue.get(timeout=0.2)
            except queue.Empty:
                with self._done_lock:
                    finished = self._done >= self.num_parallel
                if finished and self.queue.empty():
                    if self.finite:
                        raise DataOutOfRange
                    raise RuntimeError("All data workers exited unexpectedly")

    def __iter__(self, _done=DataOutOfRange):
        # _done bound at def time: when a leftover generator is finalized
        # during interpreter shutdown, module globals may already be None
        # and `except DataOutOfRange` would itself raise.
        try:
            while True:
                yield self.fetch()
        except _done:
            return

    def stop(self) -> None:
        self.stop_event.set()
        # Drain so producers blocked on put() observe the stop event.
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        for t in self.threads:
            t.join(timeout=5.0)
        for s in self._samplers:
            close = getattr(s, "close", None)
            if close:
                close()
        self._samplers = []
