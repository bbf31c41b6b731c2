"""Batched embedding extraction with length bucketing, on one device.

Counterpart of ``tf_kaldi_speaker_tpu/extract/extractor.py``: utterances are
grouped into geometric length buckets, padded and masked (masked pooling
makes the padded forward equal the unpadded one) and embedded in batches.
Utterances longer than ``chunk_size`` keep the reference's semantics: split
into 50%-overlapping windows, embed, length-weighted average, optional L2
norm (reference extract.py:69-93). ``embed_long_exact`` is not ported yet.

bf16 models follow the JAX policy (``extractor.py:100-118``): the host
casts features to bf16, and every float32 variable, BatchNorm statistics
included, is cast to bf16.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..convert import network_from_variables
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


class Extractor:
    """Loads a trained model dir and embeds utterances in device batches."""

    def __init__(
        self,
        model_dir: str,
        node: Optional[str] = None,
        batch_size: int = 32,
        chunk_size: int = 10000,
        min_chunk_size: int = 25,
        normalize: bool = False,
        device: str = "cuda",
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
        self.device = torch.device(device)
        self.batch_size = batch_size
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
            variables, self.params.dict, self.params.dict.get("network_type", "tdnn"))
        bf16 = self.params.dict.get("compute_dtype", "float32") == "bfloat16"
        self.feed_dtype = torch.bfloat16 if bf16 else torch.float32
        # Every float32 parameter and buffer (BN statistics too) in bf16.
        self.net = net.to(device=self.device, dtype=self.feed_dtype)

    # ------------------------------------------------------------------
    def _to_device(self, array: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        # The cast happens on the host: a bf16 model ships 2 bytes/element.
        t = torch.from_numpy(array).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.inference_mode()
    def _forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        _, endpoints = self.net(feats.to(self.feed_dtype), mask)
        return endpoints[self.node].to(torch.float32)

    def _embed_batch_async(self, feats: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Enqueue one batch; returns the device result without waiting, so
        the caller can assemble and enqueue the next batch first."""
        return self._forward(self._to_device(feats, self.feed_dtype),
                             self._to_device(mask, torch.float32))

    def _embed_batch(self, feats: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return self._embed_batch_async(feats, mask).cpu().numpy()

    def _bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def _rows_for(self, b: int) -> int:
        """Rows to allocate for a b-item batch: the smallest power of two
        >= b, capped at batch_size, so a bucket's final partial flush does
        not ship batch_size rows for a few stragglers."""
        r = 1
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
            emb = out.cpu().numpy()[: len(items)]
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
