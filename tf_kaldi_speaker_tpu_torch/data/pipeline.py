"""Host-side prefetching and the host-to-card transfer.

Counterpart of ``tf_kaldi_speaker_tpu/data/pipeline.py``:

- ``PrefetchLoader`` is a copy (replacing the reference's multiprocessing
  producer queues, dataset/data_loader.py:310-414): worker *threads* (the
  native reader and numpy release the GIL) fill a bounded queue; worker i
  uses seed ``base_seed + i``. Each worker closes its own sampler when it
  ends (the JAX copy closes them in ``stop()``, under a worker whose join
  timed out).
- :func:`device_prefetch` is ``device_prefetch`` in PyTorch's idiom: a
  transfer thread pins each host batch and copies it to the card with
  ``non_blocking=True`` on a side CUDA stream, ``depth`` batches ahead of
  the consumer, and hands the tensors over with an event that the
  consumer's stream waits on.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Tuple

import numpy as np
import torch

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

    def _work(self, worker_id: int) -> None:
        sampler = self.sampler_factory(self.base_seed + worker_id)
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
            # The worker closes its own sampler: a stop() whose join timed
            # out (a worker still inside a large batch) must not close the
            # readers under it.
            close = getattr(sampler, "close", None)
            if close:
                close()
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


def device_prefetch(iterator: Iterator, device, depth: int = 2,
                    threaded: bool = True) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Keep ``depth`` batches (tuples of numpy arrays) in flight onto
    ``device`` ahead of consumption; yields tuples of tensors.

    On a CUDA device each batch is pinned and copied with
    ``non_blocking=True`` on a side stream; an event recorded after the
    copies is waited on by the consumer's current stream before the batch
    is yielded, and ``record_stream`` keeps the caching allocator from
    reusing the buffers while that stream may still read them. By default
    the copies are issued from a transfer thread, so that pinning overlaps
    the consumer's step; ``threaded=False`` issues them inline as a double
    buffer. A worker's exception is raised
    on the consumer's thread. On the CPU device the arrays are wrapped with
    ``torch.from_numpy``; any other device raises (a CUDA device without
    CUDA raises where its stream is made)."""
    device = torch.device(device)
    if device.type == "cpu":
        for batch in iterator:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        return
    if device.type != "cuda":
        raise ValueError("device_prefetch: no transfer to %s" % device)
    side = torch.cuda.Stream(device)

    def _put(batch):
        with torch.cuda.stream(side):
            out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                        .to(device, non_blocking=True) for a in batch)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def _take(item):
        tensors, ready = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for t in tensors:
            t.record_stream(consumer)
        return tensors

    if not threaded:
        buf = []
        it = iter(iterator)
        try:
            for _ in range(depth):
                buf.append(_put(next(it)))
        except StopIteration:
            pass
        while buf:
            out = buf.pop(0)
            try:
                buf.append(_put(next(it)))
            except StopIteration:
                pass
            yield _take(out)
        return

    q: queue.Queue = queue.Queue(depth)
    stop = threading.Event()
    done = object()

    def _work():
        try:
            for batch in iterator:
                dev = _put(batch)
                while not stop.is_set():
                    try:
                        q.put(dev, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            item = done
        except BaseException as e:  # re-raised on the consumer thread
            item = e
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    t = threading.Thread(target=_work, daemon=True)
    t.start()
    # Bound now: if a leftover generator is finalized at interpreter
    # shutdown, the `queue` module global may already be None.
    empty_exc = queue.Empty
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield _take(item)
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except empty_exc:
            pass
        t.join(timeout=5.0)
