"""Batched embedding extraction with length bucketing, on one device or on
every local card.

Counterpart of ``tf_kaldi_speaker_tpu/extract/extractor.py``: utterances are
grouped into geometric length buckets, padded and masked (masked pooling
makes the padded forward equal the unpadded one) and embedded in batches.

One process extracts over all its devices, as the JAX ``Extractor`` runs
one program over every local device (``extractor.py:74-81, 119-146``):
``device="cuda"`` with no index means every visible card in index order
(``cuda:N`` and ``cpu`` one device; ``devices=[...]`` names them, as the
JAX ``mesh=`` does). Each distinct device holds a replica of the network;
the batch size is rounded up to a multiple of the device count n, a batch
n does not divide is padded with zero rows and a zero mask, and each batch
is cut into n row blocks, each copied to its device (pinned, non-blocking)
and run there. The rows are independent forwards, so the files written do
not depend on n; the one-deep pipelining enqueues every block of the next
batch before the previous one is read back.

Utterances longer than ``chunk_size`` keep the reference's semantics: split
into 50%-overlapping windows, embed, length-weighted average, optional L2
norm (reference extract.py:69-93). :meth:`Extractor.embed_long_exact` is
the exact alternative for the TDNN with statistics pooling (JAX
``extractor.py:287-412``): statistics pooling is associative, so the frame
layers' sums over chunks that overlap by the TDNN's context, accumulated in
float64, give the embedding of one forward over the whole utterance with
O(chunk) memory; it runs on the first device, as the JAX ``_frames_jit``
path is not sharded.

bf16 models follow the JAX policy (``extractor.py:100-118``): the host
casts features to bf16, and every float32 variable, BatchNorm statistics
included, is cast to bf16.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..convert import network_from_variables
from ..models.layers import VAR2STD_EPSILON
from ..models.tdnn import TDNN_TOTAL_CONTEXT, TDNNFrames, TDNNTail
from ..train import checkpoints
from ..utils.params import Params

log = logging.getLogger("tfks_torch.extract")


def make_length_buckets(min_len: int, max_len: int, ratio: float = 1.27) -> List[int]:
    """Geometric grid of pad-to lengths, multiples of 8."""
    out = []
    x = float(max(min_len, 8))
    while x < max_len:
        out.append(int(np.ceil(x / 8.0) * 8))
        x *= ratio
    out.append(int(np.ceil(max_len / 8.0) * 8))
    return sorted(set(out))


def resolve_devices(device: Union[str, torch.device],
                    devices: Optional[Sequence] = None) -> List[torch.device]:
    """The extraction devices: ``devices`` where given, else every visible
    card in index order for a CUDA device with no index, else ``device``
    alone. No visible card raises."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if not out:
            raise ValueError("devices: an empty list")
        return out
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device %s: no CUDA device is visible" % device)
        return [torch.device("cuda", i) for i in range(n)]
    return [device]


class Extractor:
    """Loads a trained model dir and embeds utterances in device batches,
    each batch split in row blocks over ``devices`` (see the module
    docstring)."""

    def __init__(
        self,
        model_dir: str,
        node: Optional[str] = None,
        batch_size: int = 32,
        chunk_size: int = 10000,
        min_chunk_size: int = 25,
        normalize: bool = False,
        device: Union[str, torch.device] = "cuda",
        devices: Optional[Sequence] = None,
    ):
        nnet_dir = os.path.join(model_dir, "nnet")
        if not os.path.isdir(nnet_dir):
            nnet_dir = model_dir  # allow passing the nnet dir directly
        self.params = Params(os.path.join(nnet_dir, "config.json"))
        if node:
            self.params.dict["embedding_node"] = node
        self.node = self.params.dict.get("embedding_node", "tdnn6_dense")
        with open(os.path.join(nnet_dir, "feature_dim")) as f:
            self.dim = int(f.read().strip())
        self.devices = resolve_devices(device, devices)
        self.device = self.devices[0]  # the exact long path's
        n = len(self.devices)
        # every device gets equal rows (JAX extractor.py:79)
        self.batch_size = -(-batch_size // n) * n
        self.chunk_size = chunk_size
        self.min_chunk_size = min_chunk_size
        self.normalize = normalize
        self.buckets = make_length_buckets(min_chunk_size, chunk_size)

        raw, step = checkpoints.load_checkpoint(nnet_dir)
        log.info("Loaded checkpoint step %d from %s (node %s)", step, nnet_dir, self.node)
        variables = {
            "params": raw["params"]["network"],
            "batch_stats": raw.get("batch_stats", {}).get("network", {}),
        }
        net = network_from_variables(
            variables, self.params.dict, self.params.dict.get("network_type", "tdnn"),
            input_dim=self.dim)
        bf16 = self.params.dict.get("compute_dtype", "float32") == "bfloat16"
        self.feed_dtype = torch.bfloat16 if bf16 else torch.float32
        # Every float32 parameter and buffer (BN statistics too) in bf16;
        # one replica per distinct device.
        self._replicas: Dict[str, torch.nn.Module] = {}
        for dev in self.devices:
            if str(dev) not in self._replicas:
                replica = copy.deepcopy(net) if self._replicas else net
                self._replicas[str(dev)] = replica.to(device=dev, dtype=self.feed_dtype)
        self.net = self._replicas[str(self.device)]

    # ------------------------------------------------------------------
    def _to_device(self, array: np.ndarray, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> torch.Tensor:
        # The cast happens on the host: a bf16 model ships 2 bytes/element.
        device = self.device if device is None else device
        t = torch.from_numpy(array).to(dtype)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def _row_blocks(self, *arrays: Tuple[np.ndarray, torch.dtype]
                    ) -> List[List[torch.Tensor]]:
        """Host arrays of equal rows, zero-padded to a multiple of the
        device count (zero rows, zero mask: JAX ``extractor.py:131-141``),
        cut into one row block a device and copied there; a list over the
        devices of the blocks' tensors, every copy enqueued."""
        n = len(self.devices)
        rows = arrays[0][0].shape[0]
        pad = -rows % n
        if pad:
            arrays = tuple((np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]), dt)
                           for a, dt in arrays)
        per = (rows + pad) // n
        return [[self._to_device(a[i * per:(i + 1) * per], dt, dev) for a, dt in arrays]
                for i, dev in enumerate(self.devices)]

    @torch.inference_mode()
    def _forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The forward on the replica of ``feats``' device."""
        net = self._replicas[str(feats.device)]
        _, endpoints = net(feats.to(self.feed_dtype), mask)
        return endpoints[self.node].to(torch.float32)

    def _embed_batch_async(self, feats: np.ndarray, mask: np.ndarray) -> List[torch.Tensor]:
        """Enqueue one batch, a row block a device; returns the blocks'
        device results without waiting, so the caller can assemble and
        enqueue the next batch first."""
        return [self._forward(f, m) for f, m in
                self._row_blocks((feats, self.feed_dtype), (mask, torch.float32))]

    @staticmethod
    def _gather(blocks: List[torch.Tensor]) -> np.ndarray:
        """The row blocks' results on the host, in row order."""
        return np.concatenate([b.cpu().numpy() for b in blocks], 0)

    def _embed_batch(self, feats: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return self._gather(self._embed_batch_async(feats, mask))[: feats.shape[0]]

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def _rows_for(self, b: int) -> int:
        """Rows to allocate for a b-item batch: the smallest n * 2^k >= b
        (n devices), capped at batch_size, so a bucket's final partial
        flush does not ship batch_size rows for a few stragglers."""
        r = len(self.devices)
        while r < b and r < self.batch_size:
            r *= 2
        return min(r, self.batch_size)

    def _l2(self, emb: np.ndarray) -> np.ndarray:
        return emb / np.sqrt(np.sum(np.square(emb), axis=-1, keepdims=True))

    def embed_stream(
        self, stream: Iterable[Tuple[str, np.ndarray]]
    ) -> Iterator[Tuple[str, np.ndarray]]:
        """Yield (key, embedding) for a stream of (key, features [T, D]).

        Results are emitted as buckets fill, not in input order. Batches are
        pipelined one deep: a batch's result is read back only after the
        next batch has been assembled and enqueued."""
        pending: Dict[int, List[Tuple[str, np.ndarray]]] = {}
        in_flight: List[tuple] = []  # [(items, emb_device)]

        def dispatch(bucket: int):
            items = pending.pop(bucket, [])
            if not items:
                return
            rows = self._rows_for(len(items))
            feats = np.zeros((rows, bucket, self.dim), np.float32)
            mask = np.zeros((rows, bucket), np.float32)
            for i, (_, f) in enumerate(items):
                feats[i, : f.shape[0]] = f
                mask[i, : f.shape[0]] = 1.0
            in_flight.append((items, self._embed_batch_async(feats, mask)))

        def drain(entry):
            items, out = entry
            emb = self._gather(out)[: len(items)]
            if self.normalize:
                # the reference applies a final L2 norm to both paths
                # (extract.py:92-93), not just inside the chunk average
                emb = self._l2(emb)
            for i, (key, _) in enumerate(items):
                yield key, emb[i]

        for key, feature in stream:
            T = feature.shape[0]
            if T < self.min_chunk_size:
                log.info("Key %s length too short, %d < %d, skip.", key, T, self.min_chunk_size)
                continue
            if T > self.chunk_size:
                yield key, self._embed_long(key, feature)
                continue
            bucket = self._bucket_for(T)
            pending.setdefault(bucket, []).append((key, feature))
            if len(pending[bucket]) == self.batch_size:
                dispatch(bucket)
                while len(in_flight) > 1:
                    yield from drain(in_flight.pop(0))
        for bucket in sorted(pending):
            dispatch(bucket)
        for entry in in_flight:
            yield from drain(entry)

    def _embed_long(self, key: str, feature: np.ndarray) -> np.ndarray:
        """50%-overlap chunking + length-weighted average (extract.py:69-93)."""
        T = feature.shape[0]
        half = self.chunk_size // 2
        num_chunks = int(np.ceil(float(T - self.chunk_size) / half)) + 1
        log.info("Key %s length %d > %d, split to %d chunks.", key, T, self.chunk_size, num_chunks)
        chunks, lengths = [], []
        for i in range(num_chunks):
            start = i * half
            this = self.chunk_size if T - start > self.chunk_size else T - start
            lengths.append(this)
            chunks.append(feature[start : start + this])
        by_bucket: Dict[int, List[int]] = {}
        for idx, c in enumerate(chunks):
            by_bucket.setdefault(self._bucket_for(c.shape[0]), []).append(idx)
        results: List[Optional[np.ndarray]] = [None] * num_chunks
        for bucket in sorted(by_bucket):
            idxs = by_bucket[bucket]
            for i0 in range(0, len(idxs), self.batch_size):
                sel = idxs[i0 : i0 + self.batch_size]
                rows = self._rows_for(len(sel))
                feats = np.zeros((rows, bucket, self.dim), np.float32)
                mask = np.zeros((rows, bucket), np.float32)
                for j, idx in enumerate(sel):
                    c = chunks[idx]
                    feats[j, : c.shape[0]] = c
                    mask[j, : c.shape[0]] = 1.0
                out = self._embed_batch(feats, mask)
                for j, idx in enumerate(sel):
                    results[idx] = out[j]
        embs = np.stack(results)
        weights = np.asarray(lengths, np.float64)[:, None]
        if self.normalize:
            embs = self._l2(embs)
        emb = (np.sum(embs * weights, axis=0) / np.sum(weights)).astype(np.float32)
        if self.normalize:
            emb = self._l2(emb)
        return emb

    def embed_utterance(self, feature: np.ndarray) -> np.ndarray:
        """Single-utterance path (same numbers as embed_stream)."""
        out = list(self.embed_stream([("utt", feature)]))
        if not out:
            raise ValueError("utterance shorter than min_chunk_size")
        return out[0][1]

    # ------------------------------------------------------------------
    # Exact long-utterance path (JAX extractor.py:287-412)
    # ------------------------------------------------------------------
    def _exact_long_parts(self) -> Tuple[TDNNFrames, TDNNTail]:
        """The frame-level and utterance-level halves of the loaded TDNN;
        raises for another network or pooling."""
        cfg = self.params.dict
        if cfg.get("network_type", "tdnn") != "tdnn":
            raise ValueError(
                "exact long-utterance extraction requires the TDNN network "
                "(network_type=%r)" % cfg.get("network_type"))
        if cfg.get("pooling_type") != "statistics_pooling":
            raise ValueError("exact long-utterance extraction requires statistics pooling "
                             "(pooling_type=%r)" % cfg.get("pooling_type"))
        tdnn = self.net.tdnn
        return TDNNFrames(tdnn), TDNNTail(tdnn, cfg)

    @torch.inference_mode()
    def _chunk_sums(self, frames: TDNNFrames, piece: np.ndarray, n_valid: int):
        """(count, sum, sum of squares) over the first ``n_valid`` output
        frames of the frame layers on ``piece`` [T, D], summed in float32
        on the device."""
        h = frames(self._to_device(piece[None], self.feed_dtype))[0].to(torch.float32)
        h = h[:n_valid]
        return float(n_valid), torch.sum(h, dim=0), torch.sum(torch.square(h), dim=0)

    def embed_long_exact(self, feature: np.ndarray) -> np.ndarray:
        """Exact embedding of an utterance of any length, in O(chunk) memory.

        Chunks of ``min(chunk_size, max(min_chunk_size, 4096))`` frames
        overlap by the TDNN's context, so every output frame of the frame
        layers is computed exactly once; the trailing short piece is padded
        to a length bucket and its padded rows masked out. Each chunk's sums
        are taken in float32 on the device and accumulated in float64 on the
        host (a one-pass E[x^2] - mean^2 in float32 would cancel over long
        inputs); then the utterance-level layers run on the pooled vector."""
        frames, tail = self._exact_long_parts()
        ctx = TDNN_TOTAL_CONTEXT
        T = feature.shape[0]
        if T <= ctx:
            raise ValueError(
                "utterance too short for the exact long path "
                "(%d frames <= TDNN context %d)" % (T, ctx))
        chunk = min(self.chunk_size, max(self.min_chunk_size, 4096))
        step = chunk - ctx
        count, s1, s2 = 0.0, None, None
        start = 0
        while start < T - ctx:
            piece = np.asarray(feature[start:start + chunk], np.float32)
            if piece.shape[0] < chunk:
                padded = np.zeros((self._bucket_for(piece.shape[0]), piece.shape[1]), np.float32)
                padded[:piece.shape[0]] = piece
                c, a, b = self._chunk_sums(frames, padded, piece.shape[0] - ctx)
            else:
                c, a, b = self._chunk_sums(frames, piece, chunk - ctx)
            a64 = a.cpu().numpy().astype(np.float64)
            b64 = b.cpu().numpy().astype(np.float64)
            count += c
            s1 = a64 if s1 is None else s1 + a64
            s2 = b64 if s2 is None else s2 + b64
            start += step
        mean = s1 / count
        var = np.maximum(s2 / count - mean * mean, 0.0)
        std = np.sqrt(np.where(var <= VAR2STD_EPSILON, VAR2STD_EPSILON, var))
        pooled = np.concatenate([mean, std]).astype(np.float32)
        with torch.inference_mode():
            endpoints = tail(self._to_device(pooled[None], self.feed_dtype))
            emb = endpoints[self.node][0].to(torch.float32).cpu().numpy()
        if self.normalize:
            emb = emb / np.sqrt(np.sum(np.square(emb)))
        return emb
