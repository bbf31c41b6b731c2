"""Multi-input trainer: main features + named auxiliary feature streams.

Counterpart of ``tf_kaldi_speaker_tpu/train/trainer_mi.py`` (reference
model/trainer_mi.py, ``TrainerMultiInput``) on one card or on a mesh of
ranks, as :class:`Trainer`. The network
receives a dict of aux streams (bottleneck features, ...) cut at the same
start frame as the main chunk; ``aux_feature_dim`` (name -> width) must be
configured, and the streams reach the network as the endpoints
``aux_<name>`` and by concatenation onto the input (``models/tdnn.py``).

- The train step is :meth:`Trainer.train_step` with the aux dict: under
  ``compute_dtype: bfloat16`` the main and aux streams are both cast; the
  attention penalty and the frozen masks are the base step's.
- :meth:`train` runs one epoch in K-step groups from
  ``KaldiMultiDataRandomQueue`` (seeded ``seed + step0``; over several
  data ranks each its share of the speakers, seed ``seed + step0 + d *
  7919``, one worker and the shared length seed, JAX ``:240-300``) through
  :func:`device_prefetch`, the aux streams moved with the main batch;
  progress, checkpoints and the stop poll keep ``Trainer``'s cadences. The
  JAX multi-input trainer writes no summaries and no profile, so neither
  does this one.
- :meth:`valid` is ``Trainer.valid`` over the multi-stream loaders (softmax
  or ``end2end`` batches, margins neutralized, ``output_embeddings``).
- :meth:`predict` is rank-checked as in JAX ``trainer_mi.py:452-471``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..data import KaldiMultiDataRandomQueue, device_prefetch
from .trainer import Trainer, _group_mean

log = logging.getLogger("tfks_torch.trainer_mi")


class TrainerMultiInput(Trainer):
    def __init__(self, params, model_dir: str, dim: Optional[int] = None,
                 num_speakers: Optional[int] = None, device="cuda"):
        assert "aux_feature_dim" in params.dict, (
            "The dim of auxiliary features must be specified as a dict.")
        super().__init__(params, model_dir, dim=dim, num_speakers=num_speakers, device=device)
        self.aux_dims: Dict[str, int] = dict(params.aux_feature_dim)

    def build(self, mode: str, dim: Optional[int] = None, loss_type: Optional[str] = None,
              num_speakers: Optional[int] = None, noupdate_var_list=None) -> None:
        """As :meth:`Trainer.build`; ``mode="predict"`` only assembles the
        model (the JAX trainer's predict program)."""
        super().build("valid" if mode == "predict" else mode, dim, loss_type, num_speakers,
                      noupdate_var_list)

    def train(self, data_dir: str, spklist: str, learning_rate: float,
              aux_data: Optional[Dict[str, str]] = None) -> None:
        """One epoch of num_steps_per_epoch steps on the main and aux streams
        (``aux_data``: name -> data dir); mid-epoch --cont resumes the
        remainder of the epoch."""
        cfg = self.params.dict
        step0, steps_left, K = self._epoch_plan()
        groups = self._multi_groups(data_dir, spklist, aux_data, learning_rate, step0,
                                    steps_left, K)
        self._run_epoch(dict(cfg, save_summary_steps=0, profile_steps=0), groups, K, step0)

    def _multi_groups(self, data_dir, spklist, aux_data, learning_rate, step0, steps_left, K):
        """The epoch's groups: one loader draw of K batches at one bucket
        length per group, the main stream, the aux streams (sorted by name)
        and the labels moved to the card two groups ahead. Yields each
        group's metrics."""
        cfg = self.params.dict
        names = sorted(aux_data)
        loader = KaldiMultiDataRandomQueue(
            data_dir, aux_data, spklist,
            max_qsize=int(cfg.get("max_queue_size", 10)),
            num_segments=int(cfg.get("num_segments_per_speaker", 1)),
            min_len=int(cfg.get("min_segment_len", 200)),
            max_len=int(cfg.get("max_segment_len", 400)),
            group=K,
            **self._loader_share(step0, int(cfg.get("num_parallel_datasets", 4))),
        ).start()

        def host_groups():
            for _ in range(steps_left // K):
                features, labels = loader.fetch()
                batch = (features["features"], *[features[n] for n in names], labels)
                yield batch if K > 1 else tuple(a[None] for a in batch)

        stream = device_prefetch(host_groups(), self.device)
        try:
            for stacked in stream:
                yield self._global_mean(_group_mean([
                    self.train_step(stacked[0][k], stacked[-1][k], learning_rate,
                                    {n: stacked[1 + i][k] for i, n in enumerate(names)})
                    for k in range(K)]))
        finally:
            loader.stop()
            stream.close()

    @torch.no_grad()
    def predict(self, features: np.ndarray,
                aux_features: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        """The ``embedding_node`` endpoint in eval mode, float32: features
        [B, L, D] or [L, D], the aux streams of the same rank and length
        (reference trainer_mi.py:590-619)."""
        aux_features = dict(aux_features or {})
        rank2 = features.ndim == 2
        if rank2:
            features = features[None]
            aux_features = {k: v[None] for k, v in aux_features.items()}
        for name, v in aux_features.items():
            assert v.ndim == 3 and v.shape[1] == features.shape[1], name
        node = self.params.dict.get("embedding_node", "tdnn6_dense")
        _, endpoints = self.network_model.eval().network(
            torch.as_tensor(features, device=self.device), None,
            {k: torch.as_tensor(v, device=self.device) for k, v in aux_features.items()})
        out = endpoints[node].float().cpu().numpy()
        return out[0] if rank2 else out
