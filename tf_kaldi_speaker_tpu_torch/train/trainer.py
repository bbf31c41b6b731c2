"""The trainer: network + loss head, the train step, the optimizer, the
epoch loops (streaming loader or device pool), fine-tuning, the LR sweep,
and the preemption poll.

Counterpart of ``tf_kaldi_speaker_tpu/train/trainer.py``, on one card or
on a mesh of ranks (one process a card, ``parallel/``):

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
- :meth:`Trainer.valid` is ``valid`` (``:1319-1445``): sequential
  batches (``batch_type: "softmax"``) or speaker-major random batches of
  ``num_valid_speakers_per_batch x num_valid_segments_per_speaker``
  (``"end2end"``), margins neutralized, ``angular_triplet_loss`` validated
  with ``e2e_valid_loss``, polling for a stop at every batch.
- The generalized triplet's "average" centers (the JAX ``loss_stats``
  collection) are a buffer of the loss head: they move in the train step,
  and travel through checkpoints, ``--cont`` and fine-tuning.
- :meth:`Trainer.get_finetune_model` (``:748-787``) and
  :meth:`Trainer.train_tune_lr` (``:1268-1317``).
- Multi-input models (``train/trainer_mi.py``): :meth:`Trainer.train_step`
  and :meth:`Trainer.valid` take the aux streams beside the main one.
- The multitask trainer (``multitask/trainer.py``) builds its own module
  (:meth:`Trainer._make_model`) and shares the update
  (:meth:`Trainer._update`), the checkpoints and the epoch driver.

Data parallelism (JAX: one pjit'd step over the ``data`` mesh axis,
``:327-436``): the trainer's mesh (``parallel.make_mesh``, with
``model_parallel``) places the model (``parallel.shard_model``). Each rank
runs the forward on its own rows; every BatchNorm takes the global batch's
statistics; the loss head computes the global batch's loss from the
gathered embeddings; each rank's objective is 1/D of loss + L2 + penalty
(D data ranks), so that the gradients, summed over the data group in one
flat bucket, are the global batch's with the L2 term counted once;
``clip_by_global_norm`` and the optimizer then run on the summed
gradients, identically on every rank. The metrics are global means. The
streaming epoch splits ``num_speakers_per_batch`` over the data ranks,
each with its own loader (one worker, seed ``seed + step0 + d * 7919``)
and the shared ``length_seed``; the device pool is sharded over the data
ranks (``ShardedDevicePool``, ``:1032-1206``); validation gives each rank
its row block of the same global batch, padded with weight-0 rows; rank 0
alone writes checkpoints (the split kernel joined whole first) and
summaries; the stop poll is collective. A world of one rank is the
single-card path: no group, no collective.
"""

from __future__ import annotations

import itertools
import logging
import os
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from .. import convert
from ..data import (DataOutOfRange, KaldiDataRandomQueue, KaldiDataSeqQueue,
                    KaldiMultiDataRandomQueue, KaldiMultiDataSeqQueue, bucket_lengths,
                    device_prefetch)
from ..data.device_pool import DevicePool, ShardedDevicePool, gather_chunks
from ..losses import STRUCTURAL_LOSSES, LossHead
from ..models.tdnn import EntireNetwork
from ..ops.cm_dequant import cm_dequantize
from ..parallel import make_mesh, pad_batch_to_devices, shard_model, sharded_dim
from ..parallel.mesh import reduce_replicated
from ..parallel.sharding_rules import gather_named, gather_tree, split_tree
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
                sample_weight=None, aux_enabled=True, loss_func=None, aux_features=None):
        out, endpoints = self.network(features, mask, aux_features)
        loss, ep = self.softmax(out, labels, step, margin_override, sample_weight,
                                aux_enabled, loss_func)
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


def _to(aux: Optional[Dict[str, torch.Tensor]], device) -> Optional[Dict[str, torch.Tensor]]:
    return None if aux is None else {k: v.to(device) for k, v in aux.items()}


def _row_block(features, aux, labels, mesh):
    """This data rank's rows of a global batch padded to a multiple of the
    data ranks by repeating its last row (JAX ``_pad_rows``), with row
    weights 0 on the padding: (features, aux, labels, weights)."""
    b = features.shape[0]
    blk = pad_batch_to_devices(b, mesh) // mesh.data_size
    rows = torch.arange(mesh.data_rank * blk, (mesh.data_rank + 1) * blk)
    weights = (rows < b).to(torch.float32)
    rows = rows.clamp_max(b - 1)
    return (features[rows], None if aux is None else {k: v[rows] for k, v in aux.items()},
            labels[rows], weights)


def _split_streams(features, labels):
    """A loader batch as (main features, aux dict or None, labels) with the
    features as tensors: the multi-stream loaders give a dict of streams,
    the main one under "features"."""
    if not isinstance(features, dict):
        return torch.from_numpy(features), None, labels
    aux = {k: torch.from_numpy(v) for k, v in features.items() if k != "features"}
    return torch.from_numpy(features["features"]), aux, labels


class Trainer:
    """Owns model assembly, the train step, the data feeds and the
    checkpoint store. ``device`` is where everything runs (``cuda`` unless
    the caller asks for ``cpu``); there is no fallback. The mesh spans the
    process group's ranks (``parallel.initialize``), one rank without
    one."""

    def __init__(self, params, model_dir: str, dim: Optional[int] = None,
                 num_speakers: Optional[int] = None, device="cuda"):
        self.params = params
        self.model = model_dir  # <exp>/nnet
        os.makedirs(model_dir, exist_ok=True)
        self.dim = dim
        self.num_speakers = num_speakers
        self.device = torch.device(device)
        self.mesh = make_mesh(int(params.dict.get("model_parallel", 1)))
        self.network_model: Optional[XVectorModel] = None
        self.optimizer: Optional[Optimizer] = None
        self.loss_type: Optional[str] = None
        self.step = 0
        self._frozen: List[int] = []  # indices into the parameter list
        self._frozen_stats: List[torch.Tensor] = []  # BatchNorm buffers
        self._device_pool = None  # DevicePool or ShardedDevicePool
        self._trace = None  # the torch.profiler window, while open
        self._stop_requested = False
        self._stop_acknowledged = False
        # groups between collective stop polls (the JAX trainer's
        # stop_poll_groups): each poll waits for every rank
        self._stop_poll_every = int(params.dict.get("stop_poll_groups", 4))

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

    def _make_model(self, generator: torch.Generator) -> nn.Module:
        """The module the trainer trains, its parameters drawn from
        ``generator`` (on the CPU)."""
        return XVectorModel(self.params.dict, self.loss_type, self.num_speakers or 1, self.dim,
                            generator)

    def _init_state(self) -> None:
        cfg = self.params.dict
        model = self._make_model(torch.Generator().manual_seed(int(cfg.get("seed", 0))))
        self.network_model = shard_model(model, self.mesh).to(self.device)
        self._params = dict(model.named_parameters())
        self.optimizer = Optimizer(cfg, list(self._params.values()))
        self.step = 0

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def train_step(self, features: torch.Tensor, labels: torch.Tensor, lr: float,
                   aux_features: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch on the trainer's device (this rank's rows of
        the global batch); returns the step's loss, L2 term, penalty and
        accuracy as 0-d float32 tensors (no host synchronization): this
        rank's for the penalty, the global batch's for the rest.
        ``aux_features`` (multi-input models) are cast like the features.
        Training batches are never padded, so the JAX step's row weights
        have no counterpart here."""
        cfg = self.params.dict
        wreg = float(cfg.get("weight_l2_regularizer", 0.0))
        out_wreg = float(cfg.get("output_weight_l2_regularizer", wreg))
        bf16 = cfg.get("compute_dtype", "float32") == "bfloat16"
        params = self._params
        model = self.network_model.train()
        p = {k: v.to(torch.bfloat16) for k, v in params.items()} if bf16 else params
        feats = features.to(torch.bfloat16) if bf16 else features
        kwargs: Dict[str, Any] = {"step": self.step}
        if aux_features is not None:
            kwargs["aux_features"] = {k: v.to(torch.bfloat16) if bf16 else v
                                      for k, v in aux_features.items()}
        frozen_stats = [b.clone() for b in self._frozen_stats]
        loss, endpoints = functional_call(model, p, (feats, labels), kwargs)
        loss = loss.to(torch.float32)
        reg = self._l2(params, wreg, out_wreg)
        # the self-attention pooling's head-diversity penalty (trainer.py:349)
        penalty = endpoints.get("attention_penalty")
        penalty = (torch.zeros((), device=loss.device) if penalty is None
                   else penalty.to(torch.float32))
        total = loss + reg + penalty
        with torch.no_grad():
            logits = endpoints.get("logits")  # none for the triplet family
            acc = (torch.zeros((), device=loss.device) if logits is None else torch.mean(
                (model.softmax.argmax(logits) == endpoints["labels"]).to(torch.float32)))
        self._update(total, lr, frozen_stats)
        return {"loss": loss.detach(), "regularization_loss": reg.detach(),
                "penalty_loss": penalty.detach(), "accuracy": acc}

    def _l2(self, params: Dict[str, torch.Tensor], wreg: float, out_wreg: float) -> torch.Tensor:
        """:func:`l2_regularization` of the whole model: the blocks split
        over the model group contribute their sum (a value every model
        rank computes, whose gradient is each rank's block's own)."""
        if self.mesh.model_size == 1:
            return l2_regularization(params, wreg, out_wreg)
        split = {k: v for k, v in params.items()
                 if sharded_dim(convert.jax_name(k), self.mesh) is not None}
        rest = {k: v for k, v in params.items() if k not in split}
        return l2_regularization(rest, wreg, out_wreg) + reduce_replicated(
            l2_regularization(split, wreg, out_wreg), self.mesh.model_group)

    def _update(self, total: torch.Tensor, lr: float, frozen_stats: List[torch.Tensor]) -> None:
        """The step's update from the loss ``total`` (the global batch's):
        its gradients, the optimizer, ``params + (-lr * update)``, then the
        step count. ``frozen_stats`` are the frozen BatchNorm statistics as
        they were before the forward. Over D data ranks each rank
        differentiates total / D and the gradients are summed over the
        data group in one flat bucket, so every rank applies the global
        batch's update."""
        leaves = list(self._params.values())
        if self.mesh.data_size > 1:
            total = total / self.mesh.data_size
        # A parameter off the loss's graph (a pooling that taps an aux
        # stream only) gets a zero gradient, as under jax.grad.
        grads = [torch.zeros_like(p) if g is None else g for p, g in
                 zip(leaves, torch.autograd.grad(total, leaves, allow_unused=True))]
        with torch.no_grad():
            if self.mesh.data_size > 1:
                bucket = torch.cat([g.reshape(-1) for g in grads])
                dist.all_reduce(bucket, group=self.mesh.data_group)
                grads = [b.view_as(g) for b, g in
                         zip(torch.split(bucket, [g.numel() for g in grads]), grads)]
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

    def train_step_raw(self, codes: torch.Tensor, headers: torch.Tensor,
                       labels: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        """Decode on the device (``cm_dequantize``), then :meth:`train_step`."""
        return self.train_step(cm_dequantize(codes, headers), labels, lr)

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def state_tree(self) -> Dict[str, Any]:
        """The train state as a JAX-layout tree of CPU tensors, the arrays
        split over the model group joined whole (a collective: every rank
        calls it)."""
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
        return gather_tree(tree, self.mesh, self.mesh.flag_device(self.device))

    def save(self, step: int) -> None:
        """Write checkpoint ``step`` from rank 0 (JAX ``:718-725``), in the
        one-card layout whatever the mesh."""
        if self.mesh.rank != 0 and self.mesh.model_size == 1:
            return
        tree = self.state_tree()
        if self.mesh.rank == 0:
            checkpoints.save_checkpoint(
                self.model, tree, step,
                keep_max=int(self.params.dict.get("keep_checkpoint_max", 0)))

    def load(self, step: Optional[int] = None) -> int:
        """Restore the train state (the port's ``.pt`` or the JAX package's
        ``.msgpack``), each rank its blocks of the split arrays; returns the
        restored checkpoint's step (0 if none)."""
        if self.network_model is None:
            self.build("train", self.dim, None, self.num_speakers)
        try:
            raw, step = checkpoints.load_checkpoint(self.model, step)
        except FileNotFoundError:
            return 0
        raw = split_tree(raw, self.mesh)
        model = self.network_model
        variables = {key: raw.get(key, {}) for key in ("params", "batch_stats", "loss_stats")}
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
            fresh = shard_model(self._make_model(g), self.mesh).state_dict()
            with torch.no_grad():
                for name, t in self.network_model.state_dict().items():
                    if _matches(name, noload_var_list):
                        t.copy_(fresh[name])
            self.optimizer = Optimizer(cfg, list(self._params.values()))
            log.info("Fine-tune init from step %d; reinitialized %s", restored,
                     noload_var_list)
        self.save(0)

    # ------------------------------------------------------------------
    # Preemption-graceful stop
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
        """True once a loop's poll has acted on a stop request (on every
        rank: the poll is collective); the preemption exit keys on this, not
        on the raw flag, so a rank whose SIGTERM came after the last poll
        does not leave while the others go on."""
        return self._stop_acknowledged

    def _should_stop(self, tick: int = 0, every: int = 1) -> bool:
        """Stop check at a group or batch boundary (JAX ``:677-713``). One
        rank: the flag as it stands (clearing the flag drops the
        acknowledgement at the next poll). More: every rank polls at the
        same ticks (``tick % every == every - 1``; every rank runs the
        loops in lockstep), where the flag is reduced with MAX over the
        ranks, so all leave at the same boundary."""
        if self._stop_acknowledged:
            if self._stop_requested:
                return True
            # cleared to resume after a stop (mid-epoch --cont); a stop is
            # acknowledged on every rank, so clearing is seen on all
            self._stop_acknowledged = False
        if self.mesh.world == 1:
            self._stop_acknowledged = self._stop_requested
            return self._stop_acknowledged
        if tick % every != every - 1:
            return False
        if self.mesh.any(self._stop_requested, self.device):
            self._stop_requested = self._stop_acknowledged = True
        return self._stop_acknowledged

    # ------------------------------------------------------------------
    # Loops
    # ------------------------------------------------------------------
    def train(self, data_dir: str, spklist: str, learning_rate: float) -> None:
        """One epoch of num_steps_per_epoch steps (reference trainer.py:451-520)
        from the device pool (``device_pool: true``) or the streaming
        loader. Mid-epoch --cont resumes the remainder of the epoch."""
        cfg = self.params.dict
        step0, steps_left, K = self._epoch_plan()
        if bool(cfg.get("device_pool", False)):
            groups = self._pool_groups(data_dir, spklist, learning_rate, step0, steps_left, K)
        else:
            groups = self._stream_groups(data_dir, spklist, learning_rate, step0, steps_left, K)
        self._run_epoch(cfg, groups, K, step0)

    def _epoch_plan(self) -> Tuple[int, int, int]:
        """(step0, steps left in the epoch, K): K = ``steps_per_dispatch``
        cut to divide the steps left (trainer.py:861-880)."""
        num_steps = int(self.params.dict["num_steps_per_epoch"])
        step0 = self.step
        steps_left = num_steps - step0 % num_steps
        K = max(1, min(int(self.params.dict.get("steps_per_dispatch", 8)), steps_left))
        while steps_left % K:
            K -= 1
        return step0, steps_left, K

    def _run_epoch(self, cfg, groups, K: int, step0: int) -> None:
        """Drive an epoch's groups: ``_post_group`` after each, a stop poll,
        the profiler window flushed, a checkpoint at the step reached."""
        summary_steps = int(cfg.get("save_summary_steps", 0))
        # one writer per run: rank 0's (the metrics are global)
        writer = SummaryWriter(self.model) if summary_steps and self.mesh.rank == 0 else None
        t0 = time.time()
        try:
            for local_group, metrics in enumerate(groups):
                self._post_group(cfg, writer, metrics, K, local_group, t0, step0)
                if self._should_stop(local_group, self._stop_poll_every):
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
        return self._global_mean(_group_mean([
            self.train_step_raw(*b, learning_rate) if len(b) == 3
            else self.train_step(*b, learning_rate) for b in batches]))

    def _global_mean(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The metrics' mean over the data ranks (one all-reduce)."""
        if self.mesh.data_size == 1:
            return metrics
        keys = sorted(metrics)
        values = torch.stack([metrics[k].to(torch.float64) for k in keys])
        dist.all_reduce(values, group=self.mesh.data_group)
        values = values / self.mesh.data_size
        return {k: v.to(metrics[k].dtype) for k, v in zip(keys, values)}

    def _loader_share(self, step0: int, num_parallel: int) -> Dict[str, Any]:
        """This rank's part of a random loader (JAX ``:861-930``): its
        share of ``num_speakers_per_batch``, seed ``seed + step0 + d *
        7919`` (d the data rank); over more than one data rank one worker
        (a deterministic batch order) and the shared length seed ``seed +
        step0``, so every rank draws the same bucket lengths."""
        cfg = self.params.dict
        n, d = self.mesh.data_size, self.mesh.data_rank
        speakers = int(cfg.get("num_speakers_per_batch", 64))
        if speakers % n:
            raise ValueError("num_speakers_per_batch=%d must divide across %d data ranks"
                             % (speakers, n))
        seed = int(cfg.get("seed", 0)) + step0
        return dict(num_parallel=1 if n > 1 else num_parallel, num_speakers=speakers // n,
                    seed=seed + d * 7919, length_seed=seed if n > 1 else None)

    def _random_queue(self, data_dir: str, spklist: str, step0: int,
                      **kw) -> KaldiDataRandomQueue:
        """The config's started random-chunk loader for this rank
        (:meth:`_loader_share`)."""
        cfg = self.params.dict
        return KaldiDataRandomQueue(
            data_dir, spklist,
            max_qsize=int(cfg.get("max_queue_size", 10)),
            num_segments=int(cfg.get("num_segments_per_speaker", 1)),
            min_len=int(cfg.get("min_segment_len", 200)),
            max_len=int(cfg.get("max_segment_len", 400)),
            num_buckets=int(cfg.get("num_buckets", 8)),
            **self._loader_share(step0, int(cfg.get("num_parallel_datasets", 4))),
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
        are gathered and dequantized on the card. The pool is sharded over
        the data ranks by default when there are more than one
        (``pool_sharded``; a replicated pool cannot feed them, as in JAX
        multi-host): each rank samples its rows from its own shard, never
        padded. Every rank stages the same windows at the same groups and
        draws the same lengths. Yields each group's metrics."""
        cfg = self.params.dict
        num_steps = int(cfg["num_steps_per_epoch"])
        num_speakers = int(cfg.get("num_speakers_per_batch", 64))
        num_segments = int(cfg.get("num_segments_per_speaker", 1))
        buckets = bucket_lengths(
            int(cfg.get("min_segment_len", 200)),
            int(cfg.get("max_segment_len", 400)),
            int(cfg.get("num_buckets", 8)),
        )
        n_data = self.mesh.data_size
        sharded = bool(cfg.get("pool_sharded", n_data > 1))
        if n_data > 1 and not sharded:
            raise ValueError("a device_pool over %d data ranks requires pool_sharded" % n_data)
        kind = ShardedDevicePool if sharded else DevicePool
        pool = self._device_pool
        if pool is None or pool.data_dir != data_dir or not isinstance(pool, kind):
            if pool is not None:
                pool.close()
            kw = dict(num_shards=n_data, shard=self.mesh.data_rank) if sharded else {}
            pool = self._device_pool = kind(
                data_dir, spklist,
                budget_bytes=int(float(cfg.get("pool_budget_mb", 12000)) * (1 << 20)),
                device=self.device, seed=int(cfg.get("seed", 0)),
                rotation_unit=str(cfg.get("pool_rotation_unit", "utts")),
                chunk_frames=max(buckets), **kw,
            )
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
        # rank-disjoint sampling streams; the length stream is shared
        rng = random.Random(int(cfg.get("seed", 0)) + step0 + self.mesh.data_rank * 7919)
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
        crossing does not wait for the device. Rank 0 alone profiles, logs
        and writes; a histogram of a split array is joined first, on every
        rank."""
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
        if profile_steps and local_group == 10 // K and self._trace is None \
                and self.mesh.rank == 0:
            self._trace = start_trace(self.device)
        if self._trace is not None and local_group >= (10 + profile_steps) // K + 1:
            stop_trace(self._trace, os.path.join(self.model, "profile"))
            self._trace = None
        if show and (local_step % show) < K:
            m = {k: float(v) for k, v in metrics.items()}
            log.info("step %d: loss %.4f reg %.4f acc %.3f (%.2f steps/s)",
                     gstep, m["loss"], m["regularization_loss"], m["accuracy"],
                     (local_step + 1) / (time.time() - t0))
        if summary_steps and gstep // summary_steps > (gstep - K) // summary_steps:
            histograms = None
            if cfg.get("save_histograms", True) and (writer or self.mesh.model_size > 1):
                # per-variable histograms (reference trainer.py:431)
                histograms = gather_named(
                    {convert.jax_name(name): convert.to_jax_layout(name, p)
                     for name, p in self._params.items()},
                    self.mesh, self.mesh.flag_device(self.device))
            if writer:
                # the JAX step's metrics, in the order jax.device_get gives them
                m = dict(metrics, total_loss=metrics["loss"] + metrics["regularization_loss"]
                         + metrics["penalty_loss"])
                writer.scalars(gstep, {k: float(m[k]) for k in sorted(m)})
                if histograms is not None:
                    writer.histograms(gstep, {k: v.numpy().ravel()
                                              for k, v in histograms.items()})
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
    def embed(self, features: torch.Tensor,
              aux_features: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Eval-mode network output (``endpoints["output"]``), float32."""
        out, _ = self.network_model.eval().network(features.to(self.device), None,
                                                   _to(aux_features, self.device))
        return out

    def _valid_loss_func(self) -> Optional[str]:
        """The validation loss's override: ``angular_triplet_loss`` validates
        with ``e2e_valid_loss`` (trainer.py:583-586)."""
        return "e2e_valid_loss" if self.loss_type == "angular_triplet_loss" else None

    @torch.no_grad()
    def valid_loss(self, features: torch.Tensor, labels: torch.Tensor,
                   weights: torch.Tensor,
                   aux_features: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Eval-mode loss with the margin neutralized (trainer.py:589-602).
        ``weights`` [B] is a host tensor (0 = a padded row); a structural
        loss cannot weight a row out, so it refuses padded rows
        (trainer.py:1153-1158)."""
        loss_func = self._valid_loss_func()
        if (loss_func or self.loss_type) in STRUCTURAL_LOSSES and bool(torch.any(weights == 0)):
            raise ValueError("loss %s cannot weight padded rows out"
                             % (loss_func or self.loss_type))
        loss, _ = self.network_model.eval()(
            features.to(self.device), labels.to(self.device), self.step,
            margin_override=VALID_MARGIN_NEUTRAL.get(self.loss_type),
            sample_weight=weights.to(self.device), aux_enabled=False, loss_func=loss_func,
            aux_features=_to(aux_features, self.device))
        return loss

    def valid(self, data_dir: str, spklist: str, batch_type: str = "softmax",
              output_embeddings: bool = False, aux_data: Optional[Dict[str, str]] = None
              ) -> Tuple[float, Optional[np.ndarray], Optional[np.ndarray]]:
        """Validation: optional embedding dump pass + streamed loss pass
        (reference trainer.py:592-706). Returns (loss, embeddings, labels).
        ``aux_data`` (name -> data dir; multi-input models) reads the aux
        streams beside the main one through the multi-stream loaders, as
        the JAX ``TrainerMultiInput.valid`` does.

        Over several data ranks (JAX ``:1319-1445``) every rank streams the
        same batches (one loader worker), pads each to a multiple of the
        data ranks with weight-0 rows (a structural loss trims instead) and
        runs its row block; the head computes the global batch's loss, so
        every rank sums the same mean. The embedding dump runs each batch
        whole on every rank (an eval-mode forward is row by row)."""
        if batch_type not in ("softmax", "end2end"):
            raise ValueError("Unknown batch_type %s" % batch_type)
        if batch_type == "softmax" and self._valid_loss_func() == "e2e_valid_loss":
            # e2e_valid_loss reshapes by num_valid_speakers x
            # num_valid_segments: sequential batches cannot satisfy that
            raise ValueError(
                "angular_triplet_loss validates with batch_type='end2end' "
                "(its valid loss is the GE2E loss over speaker-major "
                "batches; reference trainer.py:272-275)")
        cfg = self.params.dict
        batch_size = int(cfg.get("num_speakers_per_batch", 64)) * int(
            cfg.get("num_segments_per_speaker", 1))
        lengths = dict(min_len=int(cfg.get("min_segment_len", 200)),
                       max_len=int(cfg.get("max_segment_len", 400)))
        if aux_data is None:
            lengths["num_buckets"] = int(cfg.get("num_buckets", 8))

            def seq_queue(**kw):
                return KaldiDataSeqQueue(data_dir, spklist, **kw)

            def random_queue(**kw):
                return KaldiDataRandomQueue(data_dir, spklist, **kw)
        else:
            # the JAX multi-stream loaders take the default bucket count
            def seq_queue(**kw):
                return KaldiMultiDataSeqQueue(data_dir, aux_data, spklist, **kw)

            def random_queue(**kw):
                return KaldiMultiDataRandomQueue(data_dir, aux_data, spklist, **kw)
        embeddings, labels_out = None, None
        workers = 1 if self.mesh.world > 1 else 2
        every = self._stop_poll_every
        if output_embeddings:
            seq = seq_queue(num_parallel=workers, batch_size=batch_size, shuffle=False,
                            **lengths).start()
            embs, labs = [], []
            try:
                for tick in itertools.count():
                    # A stop can land mid-validation; poll at batch
                    # boundaries so the grace window is not spent here.
                    if self._should_stop(tick, every):
                        break
                    features, aux, labels = _split_streams(*seq.fetch())
                    embs.append(self.embed(features, aux).cpu().numpy())
                    labs.append(labels)
            except DataOutOfRange:
                pass
            finally:
                seq.stop()
            embeddings = np.concatenate(embs, 0) if embs else np.zeros((0, 1))
            labels_out = np.concatenate(labs, 0) if labs else np.zeros((0,), np.int32)

        if batch_type == "softmax":
            loader = seq_queue(num_parallel=workers, batch_size=batch_size, shuffle=True,
                               **lengths).start()
        else:
            # speaker-major random batches (trainer.py:1395-1415)
            rows = int(cfg["num_valid_speakers_per_batch"]) * int(
                cfg["num_valid_segments_per_speaker"])
            if rows % self.mesh.data_size:
                # the structural valid losses cannot weight padded rows out
                raise ValueError(
                    "end2end validation batch (%d rows) must divide the %d data ranks; adjust "
                    "num_valid_speakers_per_batch/num_valid_segments_per_speaker"
                    % (rows, self.mesh.data_size))
            loader = random_queue(
                num_parallel=workers,
                num_speakers=int(cfg["num_valid_speakers_per_batch"]),
                num_segments=int(cfg["num_valid_segments_per_speaker"]),
                min_len=lengths["min_len"], max_len=lengths["max_len"]).start()
        structural = (self._valid_loss_func() or self.loss_type) in STRUCTURAL_LOSSES
        # Sample-count-weighted streaming mean: every real utterance counts once.
        total, count = 0.0, 0
        try:
            for it in range(int(cfg.get("valid_max_iterations", 100))):
                if self._should_stop(it, every):
                    break
                features, aux, labels = _split_streams(*loader.fetch())
                b = features.shape[0]
                n = self.mesh.data_size
                if structural and b % n:
                    # trim the tail batch to a multiple of the data ranks
                    b -= b % n
                    if b == 0:
                        continue
                    features, labels = features[:b], labels[:b]
                    aux = None if aux is None else {k: v[:b] for k, v in aux.items()}
                features, aux, labels, weights = _row_block(
                    features, aux, torch.from_numpy(labels), self.mesh)
                loss = self.valid_loss(features, labels, weights, aux)
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
