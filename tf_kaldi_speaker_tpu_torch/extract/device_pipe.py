"""Decode-on-device extraction: the host ships raw CM codes and the device
dequantizes, normalizes, selects voiced frames and embeds.

Counterpart of ``tf_kaldi_speaker_tpu/extract/device_pipe.py``. The host
reads 1 byte per element from the compressed ark and ships it untouched;
on the device, in order (``device_pipe.py:63-98``):

- Kaldi CM dequantization (``ops/cm_dequant.py``, CUDA kernel), then the
  per-row ``valid`` mask;
- sliding-window CMVN over all valid frames (``ops/cmvn.py``);
- energy VAD from the raw features (``ops/vad.py``);
- a stable compaction that moves voiced frames to the front in their
  original order (Kaldi's select-voiced-frames), the rest zeroed and
  masked out of pooling;
- the forward.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from ..ops.cm_dequant import cm_dequantize
from ..ops.cmvn import sliding_cmvn_masked
from ..ops.vad import compute_vad_energy_masked
from .extractor import Extractor

log = logging.getLogger("tfks_torch.extract.device_pipe")


class DevicePipeExtractor(Extractor):
    """Extractor whose input is raw CM codes instead of float features."""

    def __init__(
        self,
        model_dir: str,
        cmvn: bool = True,
        vad: bool = True,
        cmn_window: int = 300,
        **kwargs,
    ):
        super().__init__(model_dir, **kwargs)
        self.cmvn = cmvn
        self.vad = vad
        self.cmn_window = int(cmn_window)

    @torch.inference_mode()
    def _fwd_codes(self, codes: torch.Tensor, headers: torch.Tensor,
                   lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L, D = codes.shape
        t = torch.arange(L, device=codes.device)[None, :]
        valid = (t < lengths[:, None]).to(torch.float32)[:, :, None]
        raw = cm_dequantize(codes, headers) * valid
        feats = raw
        if self.cmvn:
            feats = sliding_cmvn_masked(raw, lengths, window=self.cmn_window) * valid
        if self.vad:
            voiced = compute_vad_energy_masked(raw, lengths)
            # Stable sort on an integer "not voiced" key: voiced frames
            # first, original order kept == select-voiced-frames.
            order = torch.argsort((~voiced).to(torch.int32), dim=1, stable=True)
            feats = torch.gather(feats, 1, order[:, :, None].expand(B, L, D))
            n_out = torch.sum(voiced, dim=1)
        else:
            n_out = lengths
        mask = (t < n_out[:, None]).to(torch.float32)
        feats = feats * mask[:, :, None]
        return self._forward(feats, mask), n_out

    # ------------------------------------------------------------------
    def embed_codes_stream(
        self, stream: Iterable[Tuple[str, np.ndarray, np.ndarray]]
    ) -> Iterator[Tuple[str, np.ndarray]]:
        """Yield (key, embedding) for (key, codes [T, D] uint8, headers
        [4, D] float32) triples (see kio.read_codes_scp).

        Utterances whose length after the pipe is below ``min_chunk_size``
        are skipped with a log line; utterances longer than ``chunk_size``
        must go through the host path (cli/extract.py routes them)."""
        pending: Dict[int, List[Tuple[str, np.ndarray, np.ndarray]]] = {}
        in_flight: List[tuple] = []  # one-deep pipeline (see embed_stream)

        def dispatch(bucket: int):
            items = pending.pop(bucket, [])
            if not items:
                return
            rows = self._rows_for(len(items))
            codes = np.zeros((rows, bucket, self.dim), np.uint8)
            headers = np.zeros((rows, 4, self.dim), np.float32)
            lengths = np.zeros((rows,), np.int64)
            for i, (_, c, h) in enumerate(items):
                codes[i, : c.shape[0]] = c
                headers[i] = h
                lengths[i] = c.shape[0]
            out = self._fwd_codes(
                self._to_device(codes, torch.uint8),
                self._to_device(headers, torch.float32),
                self._to_device(lengths, torch.int64),
            )
            in_flight.append((items, out))

        def drain(entry):
            items, (emb_dev, n_dev) = entry
            emb, n_out = emb_dev.cpu().numpy(), n_dev.cpu().numpy()
            for i, (key, _, _) in enumerate(items):
                if n_out[i] < self.min_chunk_size:
                    log.info(
                        "Key %s length too short after pipe, %d < %d, skip.",
                        key, int(n_out[i]), self.min_chunk_size,
                    )
                    continue
                e = emb[i]
                if self.normalize:
                    e = self._l2(e)  # same final L2 as the float-feature path
                yield key, e

        for key, c, h in stream:
            T = int(c.shape[0])
            if T > self.chunk_size:
                raise ValueError(
                    "utterance %s has %d frames > chunk_size=%d; route long "
                    "utterances through the host path" % (key, T, self.chunk_size)
                )
            if T < self.min_chunk_size:
                log.info("Key %s length too short, %d < %d, skip.",
                         key, T, self.min_chunk_size)
                continue
            bucket = self._bucket_for(T)
            pending.setdefault(bucket, []).append((key, c, h))
            if len(pending[bucket]) == self.batch_size:
                dispatch(bucket)
                while len(in_flight) > 1:
                    yield from drain(in_flight.pop(0))
        for bucket in sorted(pending):
            dispatch(bucket)
        for entry in in_flight:
            yield from drain(entry)
