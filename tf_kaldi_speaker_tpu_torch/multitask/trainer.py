"""Multitask trainer: joint speaker+phone training loop.

Counterpart of ``tf_kaldi_speaker_tpu/multitask/trainer.py`` (reference
model/multitask_v1/base_v1.py, ``BaseMT``) on one card or on a mesh of
ranks, on the port's ``Trainer`` (its optimizer, data-parallel update,
checkpoints, epoch loop and stop poll):

- :meth:`TrainerMultiTask.train_step` is ``step_fn`` (``trainer.py:106-170``):
  float32, or with ``compute_dtype: bfloat16`` the parameters and features
  cast for the forward as :meth:`Trainer.train_step` casts them; the
  returned metrics are ``spk_loss``, ``phn_loss``, ``regularization_loss``,
  ``spk_accuracy``, ``phn_accuracy`` (weighted as ``_phn_accuracy``) and
  ``loss`` = spk + phn (unweighted, as the JAX metrics have it);
- :meth:`train` (``:361-498``) runs one epoch in K-step groups from
  ``KaldiDataRandomQueueV2`` (seeded ``seed + step0``) through
  :func:`device_prefetch`; the per-class ``speaker_egs``/``phone_egs``
  counters are kept on the host and the phone masks drawn there from one
  ``RandomState(seed)`` in ``_shard_mt_grouped``'s order (``:337-359``);
  progress, summaries, checkpoints and the stop poll follow the JAX
  cadences, and the counters are written beside the nnet dir at the end
  (``_dump_egs_stats``, ``:500-513``);
- :meth:`train_tune_lr` (``:515-547``), :meth:`valid` (sample-count-weighted
  means, embeddings when asked, ``:549-593``), :meth:`predict_speaker` and
  :meth:`predict_phone` (edge tiling on the host, ``:595-623``).

Over several data ranks (JAX ``:360-420``) each rank loads its share of
``num_speakers_per_batch`` (seed ``seed + step0 + d * 7919``, one worker,
the shared length seed) and draws its rows' phone masks from its own mask
stream; both heads compute the global batch's losses from the gathered
rows; validation gives each rank its row block of the same global batch,
padded with weight-0 rows, the masks drawn over the padded batch as JAX
draws them. Each rank counts its own egs and rank 0 writes its local
counts, a 1/nproc sample, as the JAX trainer's process 0 does.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data import DataOutOfRange, device_prefetch
from ..parallel.mesh import all_gather
from ..train.trainer import VALID_MARGIN_NEUTRAL, Trainer, _group_mean
from .common import make_phone_masks
from .data_v2 import KaldiDataRandomQueueV2, KaldiDataSeqQueueV2
from .model import MultitaskModel

log = logging.getLogger("tfks_torch.trainer_mt")


def _accuracy(model: MultitaskModel, endpoints: Dict[str, torch.Tensor], prefix: str,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``spk`` or ``phn`` head's accuracy over the rows its loss saw
    (the global batch's, the phone subset's), honoring this rank's validity
    weights of them, gathered as the head gathers its rows (the padded
    rows; all-frames mode weights out padding frames; K-subset mode has
    none)."""
    logits = endpoints.get(prefix + "_logits")
    if logits is None:
        return torch.zeros((), device=endpoints[prefix + "_labels"].device)
    head = model.spk_softmax if prefix == "spk" else model.phn_softmax
    correct = (head.argmax(logits) == endpoints[prefix + "_labels"]).to(torch.float32)
    if weights is None:
        return torch.mean(correct)
    mesh = head.mesh
    if mesh is not None:
        weights = all_gather(weights, mesh.data_group, mesh.data_rank, mesh.data_size)
    return torch.sum(correct * weights) / torch.clamp_min(torch.sum(weights), 1e-12)


class TrainerMultiTask(Trainer):
    def __init__(self, params, model_dir: str, dim: Optional[int] = None,
                 num_speakers: Optional[int] = None, num_phones: Optional[int] = None,
                 device="cuda"):
        super().__init__(params, model_dir, dim=dim, num_speakers=num_speakers, device=device)
        self.num_phones = num_phones
        self.lc = int(params.dict["phone_left_context"])
        self.rc = int(params.dict["phone_right_context"])
        # -1 = all-frames phone loss, masked by valid_length (reference
        # common.py:43-55); positive = per-utterance random frame subset.
        self.num_frames_per_utt = int(params.dict.get("num_frames_per_utt", 10))
        self.all_phone_frames = self.num_frames_per_utt == -1
        self._mask_rng = np.random.RandomState(int(params.dict.get("seed", 0)))
        # Per-class example counters (base_v1.py:950-995).
        self.speaker_egs: Optional[np.ndarray] = None
        self.phone_egs: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def build(self, mode: str, dim: Optional[int] = None, loss_type: Optional[str] = None,
              num_speakers: Optional[int] = None, num_phones: Optional[int] = None,
              noupdate_var_list=None) -> None:
        """As :meth:`Trainer.build`, with ``num_phones``; ``mode="predict"``
        only assembles the model (the JAX trainer's predict programs)."""
        if mode not in ("train", "valid", "predict"):
            raise ValueError("mode must be 'train', 'valid' or 'predict', got %r" % mode)
        if num_phones is not None:
            self.num_phones = num_phones
        super().build("valid" if mode == "predict" else mode, dim,
                      self.params.dict.get("spk_loss_type", "softmax"), num_speakers,
                      noupdate_var_list)

    def _make_model(self, generator: torch.Generator) -> MultitaskModel:
        return MultitaskModel(self.params.dict, self.num_speakers or 1, self.num_phones or 1,
                              self.dim, generator)

    def _loader_kwargs(self):
        cfg = self.params.dict
        return dict(left_context=self.lc, right_context=self.rc,
                    min_len=int(cfg.get("min_segment_len", 200)),
                    max_len=int(cfg.get("max_segment_len", 400)))

    def _masks(self, length: np.ndarray, resample: np.ndarray) -> np.ndarray:
        """One batch's [B, K] phone frame indices from the trainer's mask
        stream (a [B, 1] placeholder in all-frames mode)."""
        if self.all_phone_frames:
            return np.zeros((length.shape[0], 1), np.int32)
        return make_phone_masks(length, resample, self.num_frames_per_utt, self._mask_rng)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def train_step(self, features: torch.Tensor, spk: torch.Tensor, phn: torch.Tensor,
                   length: torch.Tensor, idx: torch.Tensor, lr: float
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch on the trainer's device (features [B,
        L+lc+rc, D], speaker labels [B], pdf labels [B, L], valid lengths
        [B], phone frame indices [B, K]); returns the step's metrics as 0-d
        float32 tensors (no host synchronization)."""
        cfg = self.params.dict
        wreg = float(cfg.get("weight_l2_regularizer", 0.0))
        out_wreg = float(cfg.get("output_weight_l2_regularizer", wreg))
        bf16 = cfg.get("compute_dtype", "float32") == "bfloat16"
        params = self._params
        model = self.network_model.train()
        p = {k: v.to(torch.bfloat16) for k, v in params.items()} if bf16 else params
        feats = features.to(torch.bfloat16) if bf16 else features
        frozen_stats = [b.clone() for b in self._frozen_stats]
        loss, endpoints = functional_call(
            model, p, (feats, spk, phn, length, None if self.all_phone_frames else idx),
            {"step": self.step})
        loss = loss.to(torch.float32)
        reg = self._l2(params, wreg, out_wreg)
        with torch.no_grad():
            spk_acc = _accuracy(model, endpoints, "spk")
            phn_acc = _accuracy(model, endpoints, "phn", endpoints.get("phn_weight_subset"))
        self._update(loss + reg, lr, frozen_stats)
        spk_loss = endpoints["spk_loss"].detach().to(torch.float32)
        phn_loss = endpoints["phn_loss"].detach().to(torch.float32)
        return {"spk_loss": spk_loss, "phn_loss": phn_loss,
                "regularization_loss": reg.detach(), "spk_accuracy": spk_acc,
                "phn_accuracy": phn_acc, "loss": spk_loss + phn_loss}

    @torch.no_grad()
    def valid_step(self, features, spk, phn, length, idx, weights):
        """Eval-mode losses (margin neutralized, aux terms off), weighted
        accuracies and the speaker embeddings ``mu_zs`` of one batch
        (``valid_fn``, ``trainer.py:249-272``)."""
        margin = VALID_MARGIN_NEUTRAL.get(self.params.dict.get("spk_loss_type", "softmax"))
        model = self.network_model.eval()
        _, endpoints = model(
            features, spk, phn, length, None if self.all_phone_frames else idx, self.step,
            spk_margin_override=margin, aux_enabled=False, sample_weight=weights)
        return (endpoints["spk_loss"], endpoints["phn_loss"],
                _accuracy(model, endpoints, "spk", weights),
                _accuracy(model, endpoints, "phn", endpoints.get("phn_weight_subset")),
                endpoints["mu_zs"])

    # ------------------------------------------------------------------
    # Loops
    # ------------------------------------------------------------------
    def train(self, data_dir: str, ali_dir: str, spklist: str, learning_rate: float) -> None:
        """One epoch of num_steps_per_epoch steps; mid-epoch --cont resumes
        the remainder of the epoch. The egs counters are written at the
        end."""
        step0, steps_left, K = self._epoch_plan()
        groups = self._mt_groups(data_dir, ali_dir, spklist, learning_rate, step0,
                                 steps_left, K)
        self._run_epoch(self.params.dict, groups, K, step0)
        self._dump_egs_stats()

    def _random_queue_v2(self, data_dir, ali_dir, spklist, step0, group=1):
        """This rank's started V2 loader (``Trainer._loader_share``)."""
        cfg = self.params.dict
        return KaldiDataRandomQueueV2(
            data_dir, ali_dir, spklist,
            max_qsize=int(cfg.get("max_queue_size", 10)),
            num_segments=int(cfg.get("num_segments_per_speaker", 1)),
            group=group, **self._loader_kwargs(),
            **self._loader_share(step0, int(cfg.get("num_parallel_datasets", 2)))).start()

    def _mt_groups(self, data_dir, ali_dir, spklist, learning_rate, step0, steps_left, K):
        """The epoch's groups: one loader draw of K batches at one bucket
        length per group; the egs counted and the phone masks drawn on the
        host in group order, then (features, labels, ali, length, masks)
        moved to the card two groups ahead. Yields each group's metrics."""
        loader = self._random_queue_v2(data_dir, ali_dir, spklist, step0, K)
        if self.speaker_egs is None:
            self.speaker_egs = np.zeros(self.num_speakers, np.int64)
            self.phone_egs = np.zeros(self.num_phones, np.int64)

        def host_groups():
            for _ in range(steps_left // K):
                feats, _vad, ali, length, labels, resample, _vp = loader.fetch()
                if K == 1:
                    feats, ali, length, labels, resample = (
                        a[None] for a in (feats, ali, length, labels, resample))
                np.add.at(self.speaker_egs, labels.reshape(-1), 1)
                np.add.at(self.phone_egs, ali.reshape(-1), 1)
                idx = np.stack([self._masks(length[k], resample[k]) for k in range(K)])
                yield feats, labels, ali, length, idx

        stream = device_prefetch(host_groups(), self.device)
        try:
            for f, s, a, ln, idx in stream:
                yield self._global_mean(_group_mean([
                    self.train_step(f[k], s[k], a[k], ln[k], idx[k], learning_rate)
                    for k in range(K)]))
        finally:
            loader.stop()
            stream.close()

    def _post_group(self, cfg, writer, metrics, K, local_group, t0, step0):
        """The JAX multitask loop's per-group bookkeeping (``:444-463``):
        the progress line, the metrics as summaries, checkpoints; the
        crossing checks of :meth:`Trainer._post_group`."""
        gstep = step0 + (local_group + 1) * K
        local_step = local_group * K + K - 1
        show = int(cfg.get("show_training_progress", 100))
        summary_steps = int(cfg.get("save_summary_steps", 0))
        save_every = int(cfg.get("save_checkpoints_steps", cfg["num_steps_per_epoch"]))
        if show and (local_step % show) < K:
            m = {k: float(v) for k, v in metrics.items()}
            log.info("step %d: spk %.4f phn %.4f acc %.3f/%.3f (%.2f steps/s)",
                     gstep, m["spk_loss"], m["phn_loss"], m["spk_accuracy"],
                     m["phn_accuracy"], (local_step + 1) / (time.time() - t0))
        if writer and gstep // summary_steps > (gstep - K) // summary_steps:
            writer.scalars(gstep, {k: float(metrics[k]) for k in sorted(metrics)})
        if save_every and gstep // save_every > (gstep - K) // save_every:
            self.save(gstep)

    def _dump_egs_stats(self) -> None:
        """Per-class training-example counts (base_v1.py:950-995) beside
        the nnet dir. On several ranks each counts only its own egs and
        rank 0 writes its local counts (a 1/nproc sample of the global
        distribution), as the JAX trainer's process 0 does."""
        if self.mesh.rank != 0:
            return
        root = os.path.dirname(self.model)
        for name, counts in (("speaker_egs", self.speaker_egs), ("phone_egs", self.phone_egs)):
            with open(os.path.join(root, name), "w") as f:
                for i, c in enumerate(counts):
                    f.write("%d %d\n" % (i, c))

    def train_tune_lr(self, data_dir: str, ali_dir: str, spklist: str,
                      tune_period: int = 100) -> None:
        """Exponential LR sweep 1e-5 · 1.15^k (reference
        train_mt_lr_learning.py); writes ``learning_rate_tuning`` lines (k,
        lr, mean loss) beside the nnet dir and stops after a sweep whose
        mean loss is not finite or exceeds 1e4."""
        loader = self._random_queue_v2(data_dir, ali_dir, spklist, 0)

        def host_batches():
            while True:
                feats, _vad, ali, length, labels, resample, _vp = loader.fetch()
                yield feats, labels, ali, length, self._masks(length, resample)

        stream = device_prefetch(host_batches(), self.device)
        path = os.path.join(os.path.dirname(self.model), "learning_rate_tuning")
        try:
            with open(path, "w") as fp:
                for k in range(100):
                    lr = 1e-5 * (1.15 ** k)
                    losses = [self.train_step(*batch, lr)["loss"]
                              for _, batch in zip(range(tune_period), stream)]
                    mean_loss = float(np.mean([float(x) for x in losses]))
                    fp.write("%d %.8f %f\n" % (k, lr, mean_loss))
                    fp.flush()
                    log.info("lr sweep %d: lr=%.2e loss=%.4f", k, lr, mean_loss)
                    if not np.isfinite(mean_loss) or mean_loss > 1e4:
                        break
        finally:
            loader.stop()
            stream.close()

    def valid(self, data_dir: str, ali_dir: str, spklist: str,
              output_embeddings: bool = False
              ) -> Tuple[float, float, Optional[np.ndarray], Optional[np.ndarray]]:
        """One sequential pass of up to ``valid_max_iterations`` batches
        (unshuffled when the embeddings are asked for): the sample-count-
        weighted mean speaker and phone losses, and the ``mu_zs``
        embeddings and labels (None unless ``output_embeddings``)."""
        cfg = self.params.dict
        batch_size = int(cfg.get("num_speakers_per_batch", 64)) * int(
            cfg.get("num_segments_per_speaker", 1))
        loader = KaldiDataSeqQueueV2(
            data_dir, ali_dir, spklist, num_parallel=1, batch_size=batch_size,
            shuffle=not output_embeddings, **self._loader_kwargs()).start()
        spk_total, phn_total, count = 0.0, 0.0, 0
        embs, labs = [], []
        n, d = self.mesh.data_size, self.mesh.data_rank
        try:
            for it in range(int(cfg.get("valid_max_iterations", 100))):
                if self._should_stop(it, self._stop_poll_every):
                    break
                feats, _vad, ali, length, labels, resample, _vp = loader.fetch()
                b = labels.shape[0]
                # pad to a multiple of the data ranks (the last row again,
                # weight 0), draw the masks over the padded batch, then
                # take this rank's block (JAX _shard_mt)
                pad = -b % n
                rows = [np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                        for a in (feats, labels, ali, length, resample)]
                idx = self._masks(rows[3], rows[4])
                weights = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
                blk = slice(d * (b + pad) // n, (d + 1) * (b + pad) // n)
                dev = [torch.from_numpy(np.ascontiguousarray(a[blk])).to(self.device)
                       for a in (*rows[:4], idx, weights)]
                spk_loss, phn_loss, _, _, emb = self.valid_step(*dev)
                emb = all_gather(emb, self.mesh.data_group, d, n)[:b]
                # sample-count-weighted streaming means (partial tail
                # batches must not get outsized weight)
                spk_total += float(spk_loss) * b
                phn_total += float(phn_loss) * b
                count += b
                if output_embeddings:
                    embs.append(emb.float().cpu().numpy())
                    labs.append(labels)
        except DataOutOfRange:
            pass
        finally:
            loader.stop()
        spk_mean = spk_total / count if count else float("nan")
        phn_mean = phn_total / count if count else float("nan")
        embeddings = np.concatenate(embs, 0) if embs else None
        labels_out = np.concatenate(labs, 0) if labs else None
        return spk_mean, phn_mean, embeddings, labels_out

    # ------------------------------------------------------------------
    # Predict (float32, eval mode)
    # ------------------------------------------------------------------
    def _expand(self, features: np.ndarray) -> torch.Tensor:
        """[B, L, D] -> [B, lc + L + rc, D] with the edge frames tiled, on
        the trainer's device."""
        expanded = np.concatenate(
            [np.tile(features[:, :1], (1, self.lc, 1)), features,
             np.tile(features[:, -1:], (1, self.rc, 1))], axis=1)
        return torch.from_numpy(np.ascontiguousarray(expanded, np.float32)).to(self.device)

    @torch.no_grad()
    def predict_speaker(self, features: np.ndarray, feat_length=None) -> np.ndarray:
        """The ``embedding_node`` endpoint for UNEXPANDED features [L, D]
        or [B, L, D]; edges are tiled here."""
        rank2 = features.ndim == 2
        if rank2:
            features = features[None]
        b, length, _ = features.shape
        lengths = (np.full((b,), length, np.int32) if feat_length is None
                   else np.asarray(feat_length, np.int32))
        out = self.network_model.eval().predict_speaker(
            self._expand(features), torch.from_numpy(lengths).to(self.device))
        out = out.float().cpu().numpy()
        return out[0] if rank2 else out

    @torch.no_grad()
    def predict_phone(self, features: np.ndarray) -> np.ndarray:
        """Per-frame phone log-posteriors for [L, D] or [B, L, D] inputs."""
        rank2 = features.ndim == 2
        if rank2:
            features = features[None]
        out = self.network_model.eval().predict_phone(self._expand(features))
        out = out.float().cpu().numpy()
        return out[0] if rank2 else out
