"""Embedding server: dynamic micro-batching over a TCP socket.

Counterpart of ``tf_kaldi_speaker_tpu/extract/server.py``: concurrent
clients submit utterances, a collector thread groups them and flushes a
batch when it fills or ``max_wait_ms`` expires, and the device embeds the
batch through :class:`~.extractor.Extractor`.

Wire protocol (little-endian): request = int32 num_frames, int32 dim,
float32 data[num_frames * dim]; response = int32 emb_dim, float32 emb[...].
A request with num_frames == 0 closes the connection; emb_dim 0 answers an
utterance that could not be embedded.
"""

from __future__ import annotations

import logging
import queue
import socket
import socketserver
import struct
import threading
import time
from typing import Optional

import numpy as np

from .extractor import Extractor

log = logging.getLogger("tfks_torch.server")


class _Job:
    __slots__ = ("feature", "event", "result")

    def __init__(self, feature):
        self.feature = feature
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None


class EmbeddingServer:
    def __init__(
        self,
        model_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        batch_size: int = 32,
        max_wait_ms: float = 5.0,
        node: Optional[str] = None,
        device: str = "cuda",
    ):
        self.extractor = Extractor(model_dir, node=node, batch_size=batch_size,
                                   device=device)
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1000.0
        self.jobs: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._collector = threading.Thread(target=self._collect, daemon=True)

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                while True:
                    head = _recv_exact(sock, 8)
                    if head is None:
                        return
                    n, d = struct.unpack("<ii", head)
                    if n == 0:
                        return
                    body = _recv_exact(sock, n * d * 4)
                    if body is None:
                        return
                    feature = np.frombuffer(body, np.float32).reshape(n, d).copy()
                    job = _Job(feature)
                    outer.jobs.put(job)
                    job.event.wait()
                    if job.result is None:
                        # skipped (too short) or the batch failed
                        sock.sendall(struct.pack("<i", 0))
                        continue
                    emb = job.result.astype(np.float32)
                    sock.sendall(struct.pack("<i", emb.shape[0]) + emb.tobytes())

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address

    def _collect(self):
        while not self._stop.is_set():
            try:
                first = self.jobs.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            t0 = time.monotonic()
            while len(batch) < self.batch_size:
                remaining = self.max_wait - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    batch.append(self.jobs.get(timeout=remaining))
                except queue.Empty:
                    break
            stream = [("j%d" % i, j.feature) for i, j in enumerate(batch)]
            try:
                results = dict(self.extractor.embed_stream(iter(stream)))
            except Exception:
                # one bad batch must not kill the collector (every waiting
                # client would hang); fail the batch's jobs instead
                log.exception("embedding batch failed")
                results = {}
            for i, j in enumerate(batch):
                # a missing key is an utterance embed_stream skipped
                j.result = results.get("j%d" % i)
                j.event.set()

    def serve_forever(self):
        self._collector.start()
        log.info("Embedding server on %s (batch %d, wait %.1f ms)",
                 self.address, self.batch_size, self.max_wait * 1e3)
        self._server.serve_forever()

    def start_background(self):
        self._collector.start()
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self.address

    def shutdown(self):
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()
        if self._collector.is_alive():
            self._collector.join(timeout=5.0)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def embed_remote(address, feature: np.ndarray) -> np.ndarray:
    """Client helper: embed one [T, D] float32 utterance via the server."""
    feature = np.ascontiguousarray(feature, np.float32)
    with socket.create_connection(address) as sock:
        sock.sendall(struct.pack("<ii", *feature.shape) + feature.tobytes())
        head = _recv_exact(sock, 4)
        (dim,) = struct.unpack("<i", head)
        if dim <= 0:
            raise ValueError(
                "server could not embed the utterance "
                "(shorter than min_chunk_size, or batch failure)")
        body = _recv_exact(sock, dim * 4)
        return np.frombuffer(body, np.float32).copy()
