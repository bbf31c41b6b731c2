"""LossHead: the trainable classification head and the loss dispatch.

Counterpart of ``tf_kaldi_speaker_tpu/losses/head.py``: every loss of
``LOSS_NAMES`` (the softmax family, the triplet losses of :mod:`.triplet`,
GE2E and the generalized angular triplet) and the ring and MHE auxiliary
terms (``aux_loss_func``, ``head.py:140-179``):

- ``output_kernel`` [D, C]: the softmax/margin weight matrix, in the JAX
  package's layout (glorot-uniform init); the softmax family and the
  generalized triplet only.
- ``output_bias`` [C]: plain softmax only.
- ``ring_r``: the ring loss's trainable radius (a scalar, init
  ``ring_loss_init``).
- ``triplet_centers`` [D, C]: the generalized triplet's "average" centers,
  a buffer (the JAX ``loss_stats`` collection) that starts as a copy of
  the initial kernel and moves in train mode only, with no gradient
  through the update.

Margins can be overridden at call time (``margin_override``), the aux
terms switched off (``aux_enabled``) and the loss swapped (``loss_func``):
the trainer does all three during validation.

On a mesh of more than one rank (``mesh``, set by ``parallel.shard_model``)
the head computes the loss of the global batch, as pjit does: the rows of
the data group are gathered (``all_gather``: each rank's embeddings reach
every rank, and the gradient of each rank's share of the loss flows back
to the rows it came from), so the structural losses mine the whole batch
and the "average" centers move identically on every rank. Under model
parallelism the softmax family runs on this rank's column block
(``margin.ColumnShard``); the MHE term and the generalized triplet use the
whole kernel, joined over the model group, as JAX's SPMD computes them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import all_gather, all_reduce_max, all_reduce_min, gather_replicated
from . import margin as M
from . import triplet as T

LOSS_NAMES = (
    "softmax",
    "asoftmax",
    "additive_margin_softmax",
    "additive_angular_margin_softmax",
    "semihard_triplet_loss",
    "angular_triplet_loss",
    "generalized_angular_triplet_loss",
    "e2e_valid_loss",
)

# Losses whose value depends on the whole batch structure (pair/triplet
# mining, per-speaker centroids): a padded row cannot be weighted out.
STRUCTURAL_LOSSES = (
    "semihard_triplet_loss",
    "angular_triplet_loss",
    "generalized_angular_triplet_loss",
    "e2e_valid_loss",
)

SOFTMAX_FAMILY = LOSS_NAMES[:4]
# losses with the output kernel (head.py:83-89)
KERNEL_LOSSES = SOFTMAX_FAMILY + ("generalized_angular_triplet_loss",)
AUX_LOSSES = ("ring_loss", "mhe_loss")
EPS = 1e-12
_MARGIN_KEYS = {
    "asoftmax": ("asoftmax_m", "asoftmax"),
    "additive_margin_softmax": ("amsoftmax_m", "amsoftmax"),
    "additive_angular_margin_softmax": ("arcsoftmax_m", "arcsoftmax"),
}


class LossHead(nn.Module):
    """The head over ``dim``-wide embeddings and ``num_outputs`` classes;
    ``forward`` returns (loss, endpoints). Train or eval mode (the
    "average" centers' update) is the module's ``.training``."""

    def __init__(self, loss_func: str, num_outputs: int, config: Dict[str, Any],
                 dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        if loss_func not in LOSS_NAMES:
            raise NotImplementedError("Not implement %s loss" % loss_func)
        self.aux = list(config.get("aux_loss_func", []))
        for aux_name in self.aux:
            if aux_name not in AUX_LOSSES:
                raise NotImplementedError("Unsupported aux loss %s" % aux_name)
        self.loss_func = loss_func
        self.config = dict(config)
        self.num_outputs = num_outputs
        self.mesh = None
        if loss_func in KERNEL_LOSSES:
            self.output_kernel = nn.Parameter(torch.empty(dim, num_outputs))
            limit = math.sqrt(6.0 / (dim + num_outputs))
            with torch.no_grad():
                self.output_kernel.uniform_(-limit, limit, generator=generator)
        if loss_func == "generalized_angular_triplet_loss":
            if config["triplet_center"] not in ("learnable", "average"):
                raise ValueError("triplet_center %r" % config["triplet_center"])
            if config.get("loss_compute", "raw") != "raw":
                raise ValueError("loss_compute %r" % config["loss_compute"])
            if config["triplet_center"] == "average":
                self.register_buffer("triplet_centers", self.output_kernel.detach().clone())
        if loss_func == "softmax":
            self.output_bias = nn.Parameter(torch.zeros(num_outputs))
        if "ring_loss" in self.aux:
            self.ring_r = nn.Parameter(torch.tensor(float(config["ring_loss_init"])))

    def forward(
        self,
        features: torch.Tensor,
        labels: torch.Tensor,
        step=0,
        margin_override: Optional[float] = None,
        sample_weight: Optional[torch.Tensor] = None,
        aux_enabled: bool = True,
        loss_func: Optional[str] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``sample_weight`` [B] (0 = a padded row) weights the softmax
        family and the aux terms; the structural losses cannot weight rows
        out, and the trainer refuses padded batches for them.
        ``loss_func`` overrides the head's loss (validation of
        ``angular_triplet_loss`` with ``e2e_valid_loss``)."""
        cfg = self.config
        name = loss_func or self.loss_func
        if name not in LOSS_NAMES:
            raise NotImplementedError("Not implement %s loss" % name)
        mesh = self.mesh
        if mesh is not None and mesh.data_size > 1:
            rows = (mesh.data_group, mesh.data_rank, mesh.data_size)
            features = all_gather(features, *rows)
            labels = all_gather(labels, *rows)
            if sample_weight is not None:
                sample_weight = all_gather(sample_weight, *rows)
        shard = self._shard()
        kernel = getattr(self, "output_kernel", None)
        endpoints: Dict[str, torch.Tensor] = {} if kernel is None else {"softmax_w": kernel}
        if name == "softmax":
            loss, ep = M.softmax_loss(features, labels, kernel, self.output_bias, sample_weight,
                                      shard)
        elif name == "semihard_triplet_loss":
            loss, ep = T.semihard_triplet_loss(
                features, labels, float(cfg["margin"]), cfg.get("triplet_loss_squared", False))
        elif name == "angular_triplet_loss":
            loss, ep = T.angular_triplet_loss(
                features, labels, float(cfg["margin"]), cfg["triplet_type"], cfg["loss_type"])
        elif name == "e2e_valid_loss":
            loss, ep = T.e2e_valid_loss(
                features, labels, int(cfg["num_valid_speakers_per_batch"]),
                int(cfg["num_valid_segments_per_speaker"]))
        elif name == "generalized_angular_triplet_loss":
            loss, ep = self._generalized_triplet(features, labels, self._whole_kernel())
        else:
            key, prefix = _MARGIN_KEYS[name]
            m = margin_override if margin_override is not None else cfg[key]
            lam = M.margin_annealing_lambda(
                step, float(cfg[prefix + "_lambda_min"]), float(cfg[prefix + "_lambda_base"]),
                float(cfg[prefix + "_lambda_gamma"]), float(cfg[prefix + "_lambda_power"]))
            fn = {"asoftmax": M.asoftmax_loss,
                  "additive_margin_softmax": M.amsoftmax_loss,
                  "additive_angular_margin_softmax": M.arcsoftmax_loss}[name]
            m = int(m) if name == "asoftmax" else float(m)
            loss, ep = fn(features, labels, kernel, m, lam, sample_weight, shard)
        endpoints.update(ep)
        if aux_enabled:
            loss = self._aux(loss, endpoints, features, labels, sample_weight)
        endpoints["loss"] = loss
        endpoints["labels"] = labels
        return loss, endpoints

    def _shard(self) -> Optional[M.ColumnShard]:
        """This rank's column block of the classes under model parallelism."""
        mesh = self.mesh
        if mesh is None or mesh.model_size == 1 or not hasattr(self, "output_kernel"):
            return None
        width = self.output_kernel.shape[1]
        return M.ColumnShard(mesh.model_group, mesh.model_rank * width, self.num_outputs)

    def _whole_kernel(self) -> torch.Tensor:
        """The output kernel [D, C], joined over the model group when split."""
        kernel = self.output_kernel
        shard = self._shard()
        if shard is None:
            return kernel
        return gather_replicated(kernel, shard.group, self.mesh.model_rank,
                                 self.mesh.model_size, dim=1)

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """Each row's predicted class from the ``logits`` endpoint: the first
        of equal maxima, as ``torch.argmax``, across the column blocks under
        model parallelism."""
        shard = self._shard()
        if shard is None:
            return torch.argmax(logits, dim=-1)
        value, index = torch.max(logits, dim=-1)
        value = value.float()
        top = all_reduce_max(value, shard.group)
        index = torch.where(value == top, index + shard.col0,
                            torch.full_like(index, shard.num_classes))
        return all_reduce_min(index, shard.group)

    def _aux(self, loss, endpoints, features, labels, sample_weight):
        """The ring and MHE terms added to ``loss`` (reference
        loss.py:985-1037); row means honor ``sample_weight`` as the main
        losses do."""
        cfg = self.config

        def row_mean(per_row):
            if sample_weight is None:
                return torch.mean(per_row)
            return torch.sum(sample_weight * per_row) / torch.clamp_min(
                torch.sum(sample_weight), 1.0)

        for aux_name in self.aux:
            if aux_name == "ring_loss":
                r = self.ring_r
                ring = float(cfg["ring_loss_lambda"]) * row_mean(
                    torch.square(torch.linalg.vector_norm(features, dim=1) - r))
                loss = loss + ring
                endpoints["ring_loss_r"] = r
                endpoints["ring_loss"] = ring
            else:
                # minimum hyperspherical energy over the column-normalized
                # softmax weights (loss.py:1017-1034)
                kernel = self._whole_kernel()
                w_norm = kernel / torch.clamp_min(
                    torch.linalg.vector_norm(kernel, dim=0, keepdim=True), EPS)
                sel_w = w_norm.t()[labels]  # [B, D]
                mhe = float(cfg["mhe_lambda"]) / (
                    row_mean(torch.mean(2.0 - 2.0 * (sel_w @ w_norm), dim=1)) + 1e-6)
                loss = loss + mhe
                endpoints["mhe_loss"] = mhe
        return loss

    def _generalized_triplet(self, features, labels, kernel):
        """Angular triplet against class centers (loss.py:708-901), "raw"
        mode (``head.py:185-269``). With ``triplet_center: average`` the
        centers are the buffer; in train mode it moves toward each row's
        embedding first (repeated labels accumulate, as ``.at[].add``),
        without gradient, and the loss sees the moved centers."""
        cfg = self.config
        num_outputs = self.num_outputs
        margin = float(cfg["margin"])
        target_margin = float(cfg["target_margin"])
        topn = int(cfg["triplet_topn"])
        eps = 1e-12

        feats_norm = features / torch.clamp_min(
            torch.linalg.vector_norm(features, dim=1, keepdim=True), EPS)

        if cfg["triplet_center"] == "average":
            w = self.triplet_centers
            if self.training:
                decay = 1.0 - float(cfg["triplet_center_momentum"])
                with torch.no_grad():
                    delta = (w.t()[labels] - features.to(w.dtype)) * decay
                    scatter = torch.zeros_like(w.t()).index_add_(0, labels, delta)
                    w = w - scatter.t()
                    self.triplet_centers.copy_(w)
        else:
            w = kernel
        # JAX promotes a bf16 / f32 mix to f32
        dtype = torch.promote_types(feats_norm.dtype, w.dtype)

        w_norm = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=0, keepdim=True), EPS)
        # Squared euclidean distances to each (normalized) center.
        dist = (
            torch.sum(torch.square(feats_norm), dim=1, keepdim=True).to(dtype)
            - 2.0 * (feats_norm.to(dtype) @ w_norm.to(dtype))
            + torch.sum(torch.square(w_norm), dim=0, keepdim=True).to(dtype)
        )
        target_dist = torch.gather(dist, 1, labels[:, None].long())[:, 0]
        onehot = torch.nn.functional.one_hot(labels.long(), num_outputs).to(dist.dtype)
        # Push the own-class distance out of the nontarget minimum search.
        new_dist = dist * (1 - onehot) + (torch.amax(dist, dim=1, keepdim=True) + dist) * onehot
        target_mask = (target_dist > target_margin).to(dist.dtype)

        def floor(x):
            return torch.maximum(x, torch.full_like(x, 1e-16))

        if topn == 1:
            nontarget = torch.amin(new_dist, dim=1)
            tri = target_mask * floor(margin + target_dist - nontarget)
        elif topn == 0:
            tri = floor(margin + target_dist[:, None] - new_dist)
            tri = tri * (1 - onehot) * target_mask[:, None]
        else:
            neg = torch.topk(-new_dist, topn, dim=1).values
            tri = target_mask[:, None] * floor(margin + target_dist[:, None] + neg)
        loss_t = torch.sum(tri) / (torch.sum((tri > eps).to(tri.dtype)) + eps)

        center_loss = torch.sum(target_mask * target_dist) / (torch.sum(target_mask) + eps)
        between = 2.0 - 2.0 * (w_norm.t() @ w_norm)
        off_diag = 1.0 - torch.eye(num_outputs, dtype=between.dtype, device=between.device)
        between_loss = -torch.sum(off_diag * between) / (num_outputs * (num_outputs - 1))
        weight_loss = torch.linalg.vector_norm(w)

        loss = (
            float(cfg["triplet_loss_weight"]) * loss_t
            + float(cfg["center_loss_weight"]) * center_loss
            + float(cfg["between_loss_weight"]) * between_loss
            + float(cfg.get("l2_loss_weight", 0.0)) * weight_loss
        )
        return loss, {
            "average_centers": w,
            "triplet_loss": loss_t,
            "center_loss": center_loss,
            "between_loss": between_loss,
            "l2_loss": weight_loss,
        }
