"""The trainer: network + loss head, the train step, the optimizer, the
epoch loops (streaming loader or device pool), fine-tuning, the LR sweep,
and the preemption poll.

Counterpart of ``tf_kaldi_speaker_tpu/train/trainer.py`` for one card:

- :class:`XVectorModel` is ``XVectorModel`` (network + loss head, one
  module, one parameter tree in the JAX package's names).
- :meth:`Trainer.train_step` is ``step_fn`` (``trainer.py:327-396``): with
  ``compute_dtype: bfloat16`` the float32 master parameters are cast to
  bf16 for the forward (``torch.func.functional_call``, so the gradients
  arrive in float32 through the cast) and the features too; BatchNorm
  statistics, the L2 term, the optimizer and the update stay float32; the
  margin's lambda takes the step before its increment; the update is
  ``params + (-lr * update)``. Under fine-tuning (``noupdate_var_list``)
  the frozen variables' gradients are zeroed before clipping and the
  optimizer, their updates after it, and their BatchNorm statistics are
  restored after the forward (``freeze_mask``, ``_revert_frozen_stats``,
  ``:168-192``, applied at ``:368-381``); names are matched in the JAX
  layout (``network/tdnn/tdnn1_conv/kernel``, ``convert.jax_name``).
- :meth:`Trainer.train_step_raw` is ``step_fn_raw`` (``:415-421``): the
  ``cm_dequantize`` kernel, then the step.
- :class:`Optimizer` is ``make_optimizer`` (``:143-165``): optax's
  ``clip_by_global_norm`` (``t / norm * max_norm`` when norm >= max_norm,
  no epsilon), ``optax.trace`` (momentum, Nesterov as optax has it) and the
  TF1 Adam of ``_scale_by_tf1_adam`` (epsilon outside the bias correction).
- :meth:`Trainer.train` runs one epoch in groups of K =
  ``steps_per_dispatch`` steps: from the streaming loader
  (``KaldiDataRandomQueue`` through :func:`device_prefetch`, ``:861-1030``;
  raw codes decoded on the card with ``device_decode``) or from the device
  pool (``_train_device_pool``, ``:1032-1206``). The K steps of a group run
  one launch sequence after another and the group's metrics are their
  mean; the sampling (one bucket length per group) is the JAX package's.
  ``_post_group`` keeps the JAX cadences: progress, summaries
  (``save_summary_steps``, histograms), the profiler window
  (``profile_steps``), checkpoints; a stop poll follows every group.
- :meth:`Trainer.valid` is the ``batch_type="softmax"`` branch of
  ``valid`` (``:1319-1445``), margins neutralized, polling for a stop at
  every batch.
- :meth:`Trainer.get_finetune_model` (``:748-787``) and
  :meth:`Trainer.train_tune_lr` (``:1268-1317``).

Not ported, and refused where a config asks for them: ``ShardedDevicePool``
(``pool_sharded``, multi-card, ROADMAP.md §1 item 7) and the end2end
validation (ROADMAP.md §1 item 3).
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .. import convert
from ..data import (DataOutOfRange, KaldiDataRandomQueue, KaldiDataSeqQueue, bucket_lengths,
                    device_prefetch)
from ..data.device_pool import DevicePool, gather_chunks
from ..losses import LossHead
from ..models.tdnn import EntireNetwork
from ..ops.cm_dequant import cm_dequantize
from ..utils.summary import SummaryWriter, start_trace, stop_trace
from . import checkpoints

log = logging.getLogger("tfks_torch.trainer")

VALID_MARGIN_NEUTRAL = {
    # loss_type -> margin value that disables the margin at validation time
    "asoftmax": 1,
    "additive_margin_softmax": 0.0,
    "additive_angular_margin_softmax": 0.0,
}


class XVectorModel(nn.Module):
    """Network + loss head in one module; ``forward`` returns (loss,
    endpoints). Train or eval mode is the module's ``.training``."""

    def __init__(self, config: Dict[str, Any], loss_func: str, num_outputs: int,
                 input_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.network = EntireNetwork(config, input_dim,
                                     config.get("network_type", "tdnn"), generator)
        self.softmax = LossHead(loss_func, num_outputs, config, self.network.output_dim,
                                generator)

    def forward(self, features, labels, step=0, margin_override=None, mask=None,
                sample_weight=None, aux_enabled=True):
        out, endpoints = self.network(features, mask)
        loss, ep = self.softmax(out, labels, step, margin_override, sample_weight,
                                aux_enabled)
        endpoints.update(ep)
        return loss, endpoints


def l2_regularization(named_params: Dict[str, torch.Tensor], weight_scale: float,
                      output_scale: float) -> torch.Tensor:
    """TF-style kernel L2: scale * ||w||^2 / 2 over conv and dense kernels
    and the GhostVLAD centers; the loss head's output kernel uses
    ``output_weight_l2_regularizer`` (trainer.py:96-107). BatchNorm, PReLU,
    biases, the attention query and the ring radius are not regularized."""
    total = 0.0
    for name, w in named_params.items():
        if name.endswith("output_kernel"):
            total = total + 0.5 * output_scale * torch.sum(torch.square(w))
        elif name.endswith((".weight", ".vlad_centers")):
            total = total + 0.5 * weight_scale * torch.sum(torch.square(w))
    return total


class Optimizer:
    """sgd / momentum / adam over a list of float32 tensors, without the
    learning rate (trainer.py:143-165): :meth:`update` turns gradients into
    the update that the step scales by ``-lr``. State lives on the
    parameters' device."""

    def __init__(self, cfg: Dict[str, Any], params: Sequence[torch.Tensor]):
        self.name = cfg.get("optimizer", "sgd")
        self.clip = float(cfg["clip_gradient_norm"]) if cfg.get("clip_gradient", False) else None
        if self.name == "sgd":
            if "momentum" in cfg:
                raise ValueError(
                    "Using sgd as the optimizer and you should not specify the momentum.")
        elif self.name == "momentum":
            self.decay = float(cfg["momentum"])
            self.nesterov = bool(cfg.get("use_nesterov", False))
            self.trace = [torch.zeros_like(p) for p in params]
        elif self.name == "adam":
            self.b1, self.b2 = 0.9, 0.999
            self.eps = float(cfg.get("adam_epsilon", 1e-8))
            self.count = 0
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        else:
            raise ValueError("Optimizer %s is not supported" % self.name)

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        trigger = norm < self.clip
        return [torch.where(trigger, g, g / norm * self.clip) for g in grads]

    def update(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.clip is not None:
            grads = self._clip(grads)
        if self.name == "sgd":
            return grads
        if self.name == "momentum":
            # optax.trace: trace = g + decay * trace
            torch._foreach_mul_(self.trace, self.decay)
            torch._foreach_add_(self.trace, grads)
            if not self.nesterov:
                return list(self.trace)
            return torch._foreach_add(grads, torch._foreach_mul(self.trace, self.decay))
        # TF1 Adam: sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - self.b2))
        t = np.float32(self.count)
        c = float(np.sqrt(np.float32(1.0) - np.float32(self.b2) ** t)
                  / (np.float32(1.0) - np.float32(self.b1) ** t))
        denom = torch._foreach_add(torch._foreach_sqrt(self.nu), self.eps)
        return torch._foreach_div(torch._foreach_mul(self.mu, c), denom)

    def state(self) -> Dict[str, Any]:
        """{} (sgd), {"trace": [...]} or {"count", "mu", "nu"}: tensors in
        the parameters' order."""
        if self.name == "momentum":
            return {"trace": self.trace}
        if self.name == "adam":
            return {"count": self.count, "mu": self.mu, "nu": self.nu}
        return {}

    def load_state(self, state: Dict[str, Any]) -> None:
        """Copy in a :meth:`state` (tensors in the parameters' order)."""
        want = set(self.state())
        if set(state) != want:
            raise ValueError("optimizer %s expects state %s, got %s"
                             % (self.name, sorted(want), sorted(state)))
        for key, dst in self.state().items():
            if key == "count":
                self.count = int(state[key])
                continue
            for d, s in zip(dst, state[key]):
                d.copy_(s)


def _matches(name: str, substrings: Optional[Sequence[str]]) -> bool:
    """Whether the JAX name of module tensor ``name`` contains any of
    ``substrings`` (the reference's set_trainable_variables semantics)."""
    return bool(substrings) and any(sub in convert.jax_name(name) for sub in substrings)


def _group_mean(group: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {key: torch.mean(torch.stack([m[key] for m in group])) for key in group[0]}


class Trainer:
    """Owns model assembly, the train step, the data feeds and the
    checkpoint store. ``device`` is where everything runs (``cuda`` unless
    the caller asks for ``cpu``); there is no fallback."""

    def __init__(self, params, model_dir: str, dim: Optional[int] = None,
                 num_speakers: Optional[int] = None, device="cuda"):
        self.params = params
        self.model = model_dir  # <exp>/nnet
        os.makedirs(model_dir, exist_ok=True)
        self.dim = dim
        self.num_speakers = num_speakers
        self.device = torch.device(device)
        self.network_model: Optional[XVectorModel] = None
        self.optimizer: Optional[Optimizer] = None
        self.loss_type: Optional[str] = None
        self.step = 0
        self._frozen: List[int] = []  # indices into the parameter list
        self._frozen_stats: List[torch.Tensor] = []  # BatchNorm buffers
        self._device_pool: Optional[DevicePool] = None
        self._trace = None  # the torch.profiler window, while open
        self._stop_requested = False
        self._stop_acknowledged = False

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------
    def build(self, mode: str, dim: Optional[int] = None, loss_type: Optional[str] = None,
              num_speakers: Optional[int] = None,
              noupdate_var_list: Optional[List[str]] = None) -> None:
        """Assemble the model and optimizer once; ``mode="train"`` also sets
        the frozen variables (``noupdate_var_list`` substrings of JAX
        names; none when empty)."""
        if mode not in ("train", "valid"):
            raise ValueError("mode must be 'train' or 'valid', got %r" % mode)
        if dim is not None:
            self.dim = dim
        if num_speakers is not None:
            self.num_speakers = num_speakers
        if loss_type is not None:
            self.loss_type = loss_type
        if self.loss_type is None:
            self.loss_type = self.params.dict.get("loss_func", "softmax")
        if self.network_model is None:
            self._init_state()
        if mode == "train":
            self._frozen = [i for i, name in enumerate(self._params)
                            if _matches(name, noupdate_var_list)]
            self._frozen_stats = [b for name, b in self.network_model.named_buffers()
                                  if _matches(name, noupdate_var_list)]

    def _init_state(self) -> None:
        cfg = self.params.dict
        g = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        model = XVectorModel(cfg, self.loss_type, self.num_speakers or 1, self.dim, g)
        self.network_model = model.to(self.device)
        self._params = dict(model.named_parameters())
        self.optimizer = Optimizer(cfg, list(self._params.values()))
        self.step = 0

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def train_step(self, features: torch.Tensor, labels: torch.Tensor,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One step on a batch on the trainer's device; returns the step's
        loss, L2 term and accuracy as 0-d float32 tensors (no host
        synchronization). One card pads no rows, so the JAX step's row
        weights have no counterpart here."""
        cfg = self.params.dict
        wreg = float(cfg.get("weight_l2_regularizer", 0.0))
        out_wreg = float(cfg.get("output_weight_l2_regularizer", wreg))
        bf16 = cfg.get("compute_dtype", "float32") == "bfloat16"
        params = self._params
        model = self.network_model.train()
        p = {k: v.to(torch.bfloat16) for k, v in params.items()} if bf16 else params
        feats = features.to(torch.bfloat16) if bf16 else features
        frozen_stats = [b.clone() for b in self._frozen_stats]
        loss, endpoints = functional_call(model, p, (feats, labels), {"step": self.step})
        loss = loss.to(torch.float32)
        reg = l2_regularization(params, wreg, out_wreg)
        # the self-attention pooling's head-diversity penalty (trainer.py:349)
        penalty = endpoints.get("attention_penalty")
        penalty = (torch.zeros((), device=loss.device) if penalty is None
                   else penalty.to(torch.float32))
        total = loss + reg + penalty
        leaves = list(params.values())
        grads = list(torch.autograd.grad(total, leaves))
        with torch.no_grad():
            acc = torch.mean((torch.argmax(endpoints["logits"], dim=-1) == labels).to(torch.float32))
            # Frozen gradients are zeroed before clipping and the optimizer
            # (the reference differentiates the trainable variables only),
            # frozen updates after it, and frozen statistics restored.
            for i in self._frozen:
                grads[i] = grads[i] * 0.0
            upd = list(self.optimizer.update(grads))
            for i in self._frozen:
                upd[i] = upd[i] * 0.0
            torch._foreach_add_(leaves, torch._foreach_mul(upd, -float(np.float32(lr))))
            for b, old in zip(self._frozen_stats, frozen_stats):
                b.copy_(old)
        self.step += 1
        return {"loss": loss.detach(), "regularization_loss": reg.detach(),
                "penalty_loss": penalty.detach(), "accuracy": acc}

    def train_step_raw(self, codes: torch.Tensor, headers: torch.Tensor,
                       labels: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        """Decode on the device (``cm_dequantize``), then :meth:`train_step`."""
        return self.train_step(cm_dequantize(codes, headers), labels, lr)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def state_tree(self) -> Dict[str, Any]:
        """The train state as a JAX-layout tree of CPU tensors."""
        tree = convert.variables_of(self.network_model)
        names = list(self._params)
        opt = {}
        for key, value in self.optimizer.state().items():
            if key == "count":
                opt[key] = value
            else:
                opt[key] = convert.tree_from_named(zip(names, value))["params"]
        tree["opt_state"] = opt
        tree["step"] = self.step
        return tree

    def save(self, step: int) -> None:
        checkpoints.save_checkpoint(
            self.model, self.state_tree(), step,
            keep_max=int(self.params.dict.get("keep_checkpoint_max", 0)))

    def load(self, step: Optional[int] = None) -> int:
        """Restore the train state (the port's ``.pt`` or the JAX package's
        ``.msgpack``); returns the restored checkpoint's step (0 if none)."""
        if self.network_model is None:
            self.build("train", self.dim, None, self.num_speakers)
        try:
            raw, step = checkpoints.load_checkpoint(self.model, step)
        except FileNotFoundError:
            return 0
        model = self.network_model
        variables = {"params": raw["params"], "batch_stats": raw.get("batch_stats", {})}
        convert.load_variables(model, variables)
        refs = dict(self._params)
        opt = {}
        for key, value in checkpoints.opt_state_from_raw(raw.get("opt_state", {})).items():
            if key == "count":
                opt[key] = int(value)
            else:
                named = convert.named_from_tree({"params": value}, refs, "opt_state " + key)
                opt[key] = [named[k].to(self.device) for k in refs]
        self.optimizer.load_state(opt)
        self.step = int(raw["step"])
        return int(step)

    def get_finetune_model(self, noload_var_list: Optional[List[str]]) -> None:
        """Partial restore (reference trainer.py:775-819): load the
        checkpoint, restart the step at 0, re-initialize the parameters and
        BatchNorm statistics whose JAX names contain a ``noload_var_list``
        substring (from ``seed + 1``) with a fresh optimizer state, and save
        the result as checkpoint 0."""
        restored = self.load()
        self.step = 0
        if noload_var_list:
            cfg = self.params.dict
            g = torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 1)
            fresh = XVectorModel(cfg, self.loss_type, self.num_speakers or 1, self.dim,
                                 g).state_dict()
            with torch.no_grad():
                for name, t in self.network_model.state_dict().items():
                    if _matches(name, noload_var_list):
                        t.copy_(fresh[name])
            self.optimizer = Optimizer(cfg, list(self._params.values()))
            log.info("Fine-tune init from step %d; reinitialized %s", restored,
                     noload_var_list)
        self.save(0)

    # ------------------------------------------------------------------
    # Preemption-graceful stop (single process)
    # ------------------------------------------------------------------
    def request_stop(self) -> None:
        """Ask the loops to stop at the next group (or validation batch)
        boundary; the epoch then saves a checkpoint and returns normally,
        so ``--cont`` resumes mid-epoch. Safe to call from a signal handler
        (it only flips a flag)."""
        self._stop_requested = True

    @property
    def stop_requested(self) -> bool:
        return self._stop_requested

    @property
    def stop_acknowledged(self) -> bool:
        """True once a loop's poll has acted on a stop request; the
        preemption exit keys on this, not on the raw flag."""
        return self._stop_acknowledged

    def _should_stop(self) -> bool:
        """Stop check at a group or batch boundary: one process, so the
        poll acknowledges the flag as it stands (clearing the flag drops
        the acknowledgement at the next poll)."""
        self._stop_acknowledged = self._stop_requested
        return self._stop_acknowledged

    # ------------------------------------------------------------------
    # Loops
    # ------------------------------------------------------------------
    def train(self, data_dir: str, spklist: str, learning_rate: float) -> None:
        """One epoch of num_steps_per_epoch steps (reference trainer.py:451-520)
        from the device pool (``device_pool: true``) or the streaming
        loader. Mid-epoch --cont resumes the remainder of the epoch."""
        cfg = self.params.dict
        num_steps = int(cfg["num_steps_per_epoch"])
        step0 = self.step
        steps_left = num_steps - step0 % num_steps
        K = max(1, min(int(cfg.get("steps_per_dispatch", 8)), steps_left))
        while steps_left % K:
            K -= 1
        if bool(cfg.get("device_pool", False)):
            if bool(cfg.get("pool_sharded", False)):
                raise NotImplementedError(
                    "pool_sharded (ShardedDevicePool, multi-card) is not ported yet "
                    "(ROADMAP.md §1 item 7)")
            groups = self._pool_groups(data_dir, spklist, learning_rate, step0, steps_left, K)
        else:
            groups = self._stream_groups(data_dir, spklist, learning_rate, step0, steps_left, K)
        summary_steps = int(cfg.get("save_summary_steps", 0))
        writer = SummaryWriter(self.model) if summary_steps else None
        t0 = time.time()
        try:
            for local_group, metrics in enumerate(groups):
                self._post_group(cfg, writer, metrics, K, local_group, t0, step0)
                if self._should_stop():
                    break
        finally:
            groups.close()
            if self._trace is not None:
                # The profile window can outlast the epoch's group count;
                # always flush so the next epoch can start a new trace.
                stop_trace(self._trace, os.path.join(self.model, "profile"))
                self._trace = None
            if writer:
                writer.close()
        self.save(self.step)

    def _group(self, batches, learning_rate: float) -> Dict[str, torch.Tensor]:
        """K steps on the group's batches, each a tuple (features, labels)
        or (codes, headers, labels); the metrics' mean."""
        return _group_mean([
            self.train_step_raw(*b, learning_rate) if len(b) == 3
            else self.train_step(*b, learning_rate) for b in batches])

    def _random_queue(self, data_dir: str, spklist: str, step0: int,
                      **kw) -> KaldiDataRandomQueue:
        """The config's started random-chunk loader, seeded ``seed + step0``."""
        cfg = self.params.dict
        return KaldiDataRandomQueue(
            data_dir, spklist,
            num_parallel=int(cfg.get("num_parallel_datasets", 4)),
            max_qsize=int(cfg.get("max_queue_size", 10)),
            num_speakers=int(cfg.get("num_speakers_per_batch", 64)),
            num_segments=int(cfg.get("num_segments_per_speaker", 1)),
            min_len=int(cfg.get("min_segment_len", 200)),
            max_len=int(cfg.get("max_segment_len", 400)),
            seed=int(cfg.get("seed", 0)) + step0,
            num_buckets=int(cfg.get("num_buckets", 8)),
            **kw,
        ).start()

    def _stream_groups(self, data_dir, spklist, learning_rate, step0, steps_left, K):
        """The epoch's groups from the streaming loader (trainer.py:861-1030):
        one sampler draw of K batches at one bucket length per group, moved
        to the card two groups ahead by :func:`device_prefetch`; with
        ``device_decode`` the batches are raw codes and the steps decode
        them on the card. Yields each group's metrics."""
        loader = self._random_queue(data_dir, spklist, step0, group=K,
                                    raw_codes=bool(self.params.dict.get("device_decode", False)))

        def host_groups():
            for _ in range(steps_left // K):
                batch = loader.fetch()
                yield batch if K > 1 else tuple(a[None] for a in batch)

        stream = device_prefetch(host_groups(), self.device)
        try:
            for stacked in stream:
                yield self._group([tuple(a[k] for a in stacked) for k in range(K)],
                                  learning_rate)
        finally:
            # The loader first: a transfer thread blocked in fetch() then
            # returns at once and the stream's join does not wait on it.
            loader.stop()
            stream.close()

    def _pool_groups(self, data_dir, spklist, learning_rate, step0, steps_left, K):
        """The epoch's groups from the device pool (trainer.py:1032-1206):
        one bucket length and one ``sample_group`` per group; the chunks
        are gathered and dequantized on the card. Yields each group's
        metrics."""
        cfg = self.params.dict
        num_steps = int(cfg["num_steps_per_epoch"])
        num_speakers = int(cfg.get("num_speakers_per_batch", 64))
        num_segments = int(cfg.get("num_segments_per_speaker", 1))
        buckets = bucket_lengths(
            int(cfg.get("min_segment_len", 200)),
            int(cfg.get("max_segment_len", 400)),
            int(cfg.get("num_buckets", 8)),
        )
        if self._device_pool is None or self._device_pool.data_dir != data_dir:
            if self._device_pool is not None:
                self._device_pool.close()
            self._device_pool = DevicePool(
                data_dir, spklist,
                budget_bytes=int(float(cfg.get("pool_budget_mb", 12000)) * (1 << 20)),
                device=self.device, seed=int(cfg.get("seed", 0)),
                rotation_unit=str(cfg.get("pool_rotation_unit", "utts")),
                chunk_frames=max(buckets),
            )
        pool = self._device_pool
        # Rotation schedule: C coverage cycles of R windows per epoch, slot
        # boundaries at absolute epoch positions (see the JAX trainer).
        R = pool.rotation_rounds
        C = max(1, int(cfg.get("pool_rotation_cycles", 1))) if R > 1 else 1
        C = min(C, max(1, num_steps // max(1, R)))
        epoch = step0 // max(1, num_steps)

        def _window(step_in_epoch: int) -> int:
            return min(C * R - 1, C * R * step_in_epoch // num_steps)

        cur_window = _window(step0 % num_steps)
        pool.stage(epoch * C * R + cur_window)
        rng = random.Random(int(cfg.get("seed", 0)) + step0)
        length_rng = random.Random(int(cfg.get("seed", 0)) + step0)
        for local_group in range(steps_left // K):
            w = _window(step0 % num_steps + local_group * K)
            if w != cur_window:
                cur_window = w
                pool.stage(epoch * C * R + w)
            L = length_rng.choice(buckets)
            triples = np.stack(pool.sample_group(rng, K, num_speakers, num_segments, L))
            triples = torch.from_numpy(triples)
            if self.device.type == "cuda":
                triples = triples.pin_memory()
            starts, utts, labels = triples.to(self.device, non_blocking=True)
            yield self._group(
                [gather_chunks(pool.frames, pool.headers, starts[k], utts[k], L) + (labels[k],)
                 for k in range(K)], learning_rate)

    def _post_group(self, cfg, writer, metrics, K, local_group, t0, step0):
        """Per-group bookkeeping: numerics check, profiler window, progress
        log, summaries, checkpoint. Cadences are crossing checks (the step
        advances K at a time; the metrics at a crossing are the group
        mean); the global step is derived on the host, so a group without a
        crossing does not wait for the device."""
        gstep = step0 + (local_group + 1) * K
        local_step = local_group * K + K - 1
        show = int(cfg.get("show_training_progress", 100))
        summary_steps = int(cfg.get("save_summary_steps", 0))
        profile_steps = int(cfg.get("profile_steps", 0))
        save_every = int(cfg.get("save_checkpoints_steps", cfg["num_steps_per_epoch"]))
        if cfg.get("check_numerics", False):
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise FloatingPointError("Non-finite loss at step %d: %r" % (
                    gstep, {k: float(v) for k, v in metrics.items()}))
        if profile_steps and local_group == 10 // K and self._trace is None:
            self._trace = start_trace(self.device)
        if self._trace is not None and local_group >= (10 + profile_steps) // K + 1:
            stop_trace(self._trace, os.path.join(self.model, "profile"))
            self._trace = None
        if show and (local_step % show) < K:
            m = {k: float(v) for k, v in metrics.items()}
            log.info("step %d: loss %.4f reg %.4f acc %.3f (%.2f steps/s)",
                     gstep, m["loss"], m["regularization_loss"], m["accuracy"],
                     (local_step + 1) / (time.time() - t0))
        if writer and gstep // summary_steps > (gstep - K) // summary_steps:
            # the JAX step's metrics, in the order jax.device_get gives them
            m = dict(metrics, total_loss=metrics["loss"] + metrics["regularization_loss"]
                     + metrics["penalty_loss"])
            writer.scalars(gstep, {k: float(m[k]) for k in sorted(m)})
            if cfg.get("save_histograms", True):
                # per-variable histograms (reference trainer.py:431)
                writer.histograms(gstep, {
                    convert.jax_name(name): convert.to_jax_layout(name, p).numpy().ravel()
                    for name, p in self._params.items()})
        if save_every and gstep // save_every > (gstep - K) // save_every:
            self.save(gstep)

    def train_tune_lr(self, data_dir: str, spklist: str, tune_period: int = 100) -> None:
        """Exponential LR sweep 1e-5 · 1.15^k (reference trainer.py:522-590)
        from the streaming loader; writes ``learning_rate_tuning`` lines
        (k, lr, mean loss) beside the nnet dir, and stops after a sweep whose
        mean loss is not finite or exceeds 1e4."""
        max_sweeps = 100
        with open(os.path.join(os.path.dirname(self.model), "learning_rate_tuning"), "w") as fp:
            loader = self._random_queue(data_dir, spklist, 0)
            stream = device_prefetch(iter(loader), self.device)
            try:
                for k in range(max_sweeps):
                    lr = 1e-5 * (1.15 ** k)
                    losses = [self.train_step(features, labels, lr)["loss"]
                              for _, (features, labels) in zip(range(tune_period), stream)]
                    mean_loss = float(np.mean([float(x) for x in losses]))
                    fp.write("%d %.8f %f\n" % (k, lr, mean_loss))
                    fp.flush()
                    log.info("lr sweep %d: lr=%.2e loss=%.4f", k, lr, mean_loss)
                    if not np.isfinite(mean_loss) or mean_loss > 1e4:
                        break
            finally:
                loader.stop()
                stream.close()

    @torch.no_grad()
    def embed(self, features: torch.Tensor) -> torch.Tensor:
        """Eval-mode network output (``endpoints["output"]``), float32."""
        out, _ = self.network_model.eval().network(features.to(self.device))
        return out

    @torch.no_grad()
    def valid_loss(self, features: torch.Tensor, labels: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
        """Eval-mode loss with the margin neutralized (trainer.py:589-602)."""
        loss, _ = self.network_model.eval()(
            features.to(self.device), labels.to(self.device), self.step,
            margin_override=VALID_MARGIN_NEUTRAL.get(self.loss_type),
            sample_weight=weights.to(self.device), aux_enabled=False)
        return loss

    def valid(self, data_dir: str, spklist: str, batch_type: str = "softmax",
              output_embeddings: bool = False
              ) -> Tuple[float, Optional[np.ndarray], Optional[np.ndarray]]:
        """Validation: optional embedding dump pass + streamed loss pass
        (reference trainer.py:592-706). Returns (loss, embeddings, labels)."""
        if batch_type != "softmax":
            raise NotImplementedError(
                "batch_type %r validation is not ported yet (ROADMAP.md §1 item 3, "
                "with the end2end losses)" % batch_type)
        cfg = self.params.dict
        batch_size = int(cfg.get("num_speakers_per_batch", 64)) * int(
            cfg.get("num_segments_per_speaker", 1))
        lengths = dict(min_len=int(cfg.get("min_segment_len", 200)),
                       max_len=int(cfg.get("max_segment_len", 400)),
                       num_buckets=int(cfg.get("num_buckets", 8)))
        embeddings, labels_out = None, None
        if output_embeddings:
            seq = KaldiDataSeqQueue(data_dir, spklist, num_parallel=2,
                                    batch_size=batch_size, shuffle=False, **lengths).start()
            embs, labs = [], []
            try:
                while True:
                    # A stop can land mid-validation; poll at batch
                    # boundaries so the grace window is not spent here.
                    if self._should_stop():
                        break
                    features, labels = seq.fetch()
                    embs.append(self.embed(torch.from_numpy(features)).cpu().numpy())
                    labs.append(labels)
            except DataOutOfRange:
                pass
            finally:
                seq.stop()
            embeddings = np.concatenate(embs, 0) if embs else np.zeros((0, 1))
            labels_out = np.concatenate(labs, 0) if labs else np.zeros((0,), np.int32)

        loader = KaldiDataSeqQueue(data_dir, spklist, num_parallel=2,
                                   batch_size=batch_size, shuffle=True, **lengths).start()
        # Sample-count-weighted streaming mean: every real utterance counts once.
        total, count = 0.0, 0
        try:
            for _ in range(int(cfg.get("valid_max_iterations", 100))):
                if self._should_stop():
                    break
                features, labels = loader.fetch()
                b = features.shape[0]
                loss = self.valid_loss(torch.from_numpy(features), torch.from_numpy(labels),
                                       torch.ones(b))
                total += float(loss) * b
                count += b
        except DataOutOfRange:
            pass
        finally:
            loader.stop()
        mean_loss = total / count if count else float("nan")
        return mean_loss, embeddings, labels_out

    def close(self) -> None:
        if self._device_pool is not None:
            self._device_pool.close()
            self._device_pool = None
