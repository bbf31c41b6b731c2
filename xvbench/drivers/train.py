"""Training traffic: ``Trainer.train`` of the port from the device pool, as
``cli.train`` drives it.

Set-up: the corpus from the seed (``corpus.py``) written as a Kaldi data
directory; one ``Trainer`` built as ``cli.train`` builds it, with the
benchmark's weights (``weights.py``) loaded; then that object's checked
steps through ``Trainer.train``, the window's call and feed (the pool's
sampling, its K-deep triples sent to the card, the gather, the dequant,
the steps): an epoch of one step, whose gradient the optimizer's trace
holds after it, then an epoch of one group of K steps, as the window runs
each group. These epochs draw their chunks with the sampler seeded from
``--seed``, so that over runs every bucket length is checked; the window's
epoch goes back to the configuration's seed, so that every run trains on
the same lengths. Then one step at each bucket length, so that the window
meets no shape for the first time. The window is the rest of one
``Trainer.train`` epoch long enough never to end by itself, whose start
(the first group) runs before the window opens: a real epoch is tens of
thousands of steps, so its start is nothing to a user's rate. A timer asks
the trainer to stop after ``--seconds`` (it stops at the next group
boundary, as it does for a preemption), and the window ends where the
epoch would write its closing checkpoint: the benchmark replaces the
trainer's ``save`` by a device synchronisation and a clock read, so no
checkpoint is written in a run. The rate is every chunk the window trained
over the whole window.

The check follows the checked steps in the plain reference
(``reference/``, the network the configuration names): it draws the same
(utterance, start, label) triples with its copy of the pool's sampler,
decodes the codes with its own codec and trains in float32 from the same
weights (see ``reference/compare.py``).
"""

from __future__ import annotations

import os
import random
import threading
import time

import numpy as np
import torch

from tf_kaldi_speaker_tpu_torch.data import bucket_lengths
from tf_kaldi_speaker_tpu_torch.data.device_pool import gather_chunks
from tf_kaldi_speaker_tpu_torch.train.trainer import Trainer
from tf_kaldi_speaker_tpu_torch.utils.params import ParamsPlain

from xvbench import corpus as corpus_gen
from xvbench import reference, weights
from xvbench.reference import codec, common, compare, sampler


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg = dict(ctx.config)
        cfg.update(ctx.traffic["trainer"])
        if not cfg.get("device_pool", False):
            raise ValueError("the train driver trains from the device pool")
        self.cfg = cfg
        self.classes = int(cfg["num_speakers"])
        self.segs = int(cfg.get("num_segments_per_speaker", 1))
        self.speakers = int(cfg["num_speakers_per_batch"])
        self.batch = self.speakers * self.segs
        self.group = int(cfg.get("steps_per_dispatch", 8))
        self.lr = float(cfg["learning_rate"])
        self.buckets = bucket_lengths(int(cfg.get("min_segment_len", 200)),
                                      int(cfg.get("max_segment_len", 400)),
                                      int(cfg.get("num_buckets", 8)))
        self.net = reference.network(cfg)
        self.trainer = None
        self.end = None
        self.losses = None
        self.on_first_group = None

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        self.prepare()
        self.checked_steps()
        self.warm()

    def prepare(self) -> None:
        ctx = self.ctx
        self.corpus = corpus_gen.generate(ctx.traffic["corpus"], self.classes,
                                          int(self.cfg["utts_per_speaker"]), ctx.seed,
                                          os.path.join(ctx.workdir, "data"))
        self.dim = self.corpus.dim
        self.spec = self.net.param_spec(self.cfg, self.dim, self.classes)
        trainer = Trainer(ParamsPlain(**self.cfg), os.path.join(ctx.workdir, "exp", "nnet"),
                          dim=self.dim, num_speakers=self.classes, device=ctx.device)
        trainer.build("train", self.dim, self.cfg["loss_func"], self.classes)
        trainer.network_model.load_state_dict(
            weights.make(self.spec, ctx.seed, ctx.device), strict=True)

        def stamp(step):
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            self.end = time.perf_counter()

        trainer.save = stamp  # the epoch's closing checkpoint: the window ends here
        post = trainer._post_group

        def post_group(cfg, writer, metrics, K, local_group, *rest):
            if self.losses is not None:
                self.losses.append(metrics["loss"].detach().clone())
            if self.on_first_group is not None and local_group == 0:
                self.on_first_group()
            return post(cfg, writer, metrics, K, local_group, *rest)

        trainer._post_group = post_group
        self.trainer = trainer

    def _epoch(self, steps: int) -> None:
        """``Trainer.train`` over an epoch that ends ``steps`` steps on, in
        groups of ``steps_per_dispatch`` (or fewer, to divide ``steps``)."""
        self.trainer.params.dict["num_steps_per_epoch"] = self.trainer.step + steps
        self.trainer.train(self.corpus.data_dir, self.corpus.spklist, self.lr)

    def checked_steps(self) -> None:
        """Step 1 as an epoch of its own, then one epoch of one group of K
        steps; the losses (each epoch's group mean), the first gradient and
        the parameters after both, with the sampler seeded from
        ``--seed``."""
        self.losses = []
        trainer = self.trainer
        cfg = trainer.params.dict
        seed = cfg.get("seed", 0)
        cfg["seed"] = self.ctx.seed
        try:
            self._epoch(1)
            self.prog_grad = {k: t.detach().clone() for k, t in
                              zip(trainer._params, trainer.optimizer.state()["trace"])}
            self._epoch(self.group)
        finally:
            cfg["seed"] = seed
        self.prog_losses = [float(x) for x in self.losses]
        self.losses = None
        self.prog_params = {k: v.detach().clone() for k, v in trainer._params.items()}

    def warm(self) -> None:
        """One step at each bucket length, on a batch the pool gathers."""
        rng = random.Random(self.ctx.seed)
        dev = self.ctx.device
        pool = self.trainer._device_pool
        for length in self.buckets:
            starts, utts, labels = (torch.from_numpy(a[0]).to(dev) for a in
                                    pool.sample_group(rng, 1, self.speakers, self.segs, length))
            self.trainer.train_step_raw(
                *gather_chunks(pool.frames, pool.headers, starts, utts, length), labels, self.lr)

    # -- window -----------------------------------------------------------
    def window(self, seconds: float, mark) -> dict:
        """The window opens when the epoch's first group has run (the
        first group belongs to set-up: a real epoch is tens of thousands
        of steps) and closes where the epoch would write its checkpoint
        after a stop asked ``seconds`` later."""
        trainer = self.trainer
        dev = self.ctx.device
        start = {}
        timer = threading.Timer(seconds, trainer.request_stop)

        def first_group():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            start["step"] = trainer.step
            start["t0"] = mark()
            timer.start()
            self.on_first_group = None

        self.on_first_group = first_group
        try:
            self._epoch(self.group * 10 ** 7)
        finally:
            timer.cancel()
            if timer.is_alive():
                timer.join()
        steps = trainer.step - start["step"]
        window_s = self.end - start["t0"]
        chunks = steps * self.batch
        return {"window_s": window_s, "attempted": chunks, "failed": 0, "steps": steps,
                "chunks": chunks, "classes": self.classes,
                "end_to_end": {"train_chunks_per_s": (chunks / window_s, "chunks/s")}}

    # -- check --------------------------------------------------------------
    def reference_batches(self):
        """The checked steps' batches as the reference draws them:
        (features [B, L, dim] float32, labels [B]) on the run's device."""
        index = sampler.PoolIndex(self.corpus.labels, self.corpus.lengths)
        seed = self.ctx.seed
        buckets = sampler.bucket_lengths(int(self.cfg.get("min_segment_len", 200)),
                                         int(self.cfg.get("max_segment_len", 400)),
                                         int(self.cfg.get("num_buckets", 8)))
        plan = (sampler.epoch_batches(index, seed, 0, 1, 1, self.speakers, self.segs, buckets)
                + sampler.epoch_batches(index, seed, 1, self.group, self.group, self.speakers,
                                        self.segs, buckets))
        out = []
        for length, rows in plan:
            codes = [self.corpus.utt_codes(u)[st:st + length] for u, st, _ in rows]
            p = codec.percentiles(self.corpus.headers_u16[[u for u, _, _ in rows]],
                                  corpus_gen.GLOBAL_MIN, corpus_gen.GLOBAL_RANGE)
            feats = codec.decode(np.stack(codes), p)
            out.append((torch.from_numpy(feats).to(self.ctx.device),
                        torch.tensor([lab for _, _, lab in rows], device=self.ctx.device)))
        return out

    def _epoch_losses(self, losses):
        """Step 1's loss and the group's mean, as the trainer reports them."""
        return [losses[0], sum(losses[1:]) / (len(losses) - 1)]

    def free(self) -> None:
        if self.trainer is not None:
            self.trainer.close()
            self.trainer = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, side: str = "program") -> dict:
        """The numbers compared: the program's checked steps against the
        reference's. ``side`` puts another in the program's place: the
        reference in the precision below the configuration's
        (``"control"``), or the reference from weights nudged by 1e-7 of
        themselves (``"nudged"``: how far rounding alone moves the
        steps)."""
        self.free()
        ctx = self.ctx
        w0 = weights.make(self.spec, ctx.seed, ctx.device)
        names = common.trainable(self.spec)
        batches = self.reference_batches()
        ref_losses, ref_grad, ref_p = common.train_steps(self.net.Net, self.cfg, w0, names,
                                                         batches, self.lr)
        start = w0
        if side == "control":
            losses, grad, p = common.train_steps(self.net.Net, self.cfg, w0, names, batches,
                                                 self.lr, control=True)
            losses = self._epoch_losses(losses)
        elif side == "nudged":
            g = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
            start = {k: v * (1.0 + 1e-7 * torch.randn(v.shape, generator=g, device=ctx.device))
                     for k, v in w0.items()}
            losses, grad, p = common.train_steps(self.net.Net, self.cfg, start, names, batches,
                                                 self.lr)
            losses = self._epoch_losses(losses)
        else:
            losses, grad, p = self.prog_losses, self.prog_grad, self.prog_params
        return compare.training_numbers(
            losses, self._epoch_losses(ref_losses), grad, ref_grad,
            {k: p[k] - start[k] for k in names}, {k: ref_p[k] - w0[k] for k in names})
