"""LossHead: the trainable classification head and the loss dispatch.

Counterpart of ``tf_kaldi_speaker_tpu/losses/head.py`` for the softmax
family (softmax, A-, AM- and Arc-softmax) and the ring and MHE auxiliary
terms (``aux_loss_func``, ``head.py:140-179``):

- ``output_kernel`` [D, C]: the softmax/margin weight matrix, in the JAX
  package's layout (glorot-uniform init).
- ``output_bias`` [C]: plain softmax only.
- ``ring_r``: the ring loss's trainable radius (a scalar, init
  ``ring_loss_init``).

Margins can be overridden at call time (``margin_override``) and the aux
terms switched off (``aux_enabled``): the trainer does both during
validation. The triplet, GE2E and generalized-triplet losses are not ported
yet (ROADMAP.md §1 item 3) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from . import margin as M

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
AUX_LOSSES = ("ring_loss", "mhe_loss")
EPS = 1e-12
_MARGIN_KEYS = {
    "asoftmax": ("asoftmax_m", "asoftmax"),
    "additive_margin_softmax": ("amsoftmax_m", "amsoftmax"),
    "additive_angular_margin_softmax": ("arcsoftmax_m", "arcsoftmax"),
}


class LossHead(nn.Module):
    """Softmax-family head over ``dim``-wide embeddings and
    ``num_outputs`` classes; ``forward`` returns (loss, endpoints)."""

    def __init__(self, loss_func: str, num_outputs: int, config: Dict[str, Any],
                 dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        if loss_func not in LOSS_NAMES:
            raise NotImplementedError("Not implement %s loss" % loss_func)
        if loss_func not in SOFTMAX_FAMILY:
            raise NotImplementedError(
                "loss %s is not ported yet (ROADMAP.md §1 item 3: the triplet, GE2E "
                "and generalized-triplet losses)" % loss_func)
        self.aux = list(config.get("aux_loss_func", []))
        for aux_name in self.aux:
            if aux_name not in AUX_LOSSES:
                raise NotImplementedError("Unsupported aux loss %s" % aux_name)
        self.loss_func = loss_func
        self.config = dict(config)
        self.output_kernel = nn.Parameter(torch.empty(dim, num_outputs))
        limit = math.sqrt(6.0 / (dim + num_outputs))
        with torch.no_grad():
            self.output_kernel.uniform_(-limit, limit, generator=generator)
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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg, name, kernel = self.config, self.loss_func, self.output_kernel
        endpoints: Dict[str, torch.Tensor] = {"softmax_w": kernel}
        if name == "softmax":
            loss, ep = M.softmax_loss(features, labels, kernel, self.output_bias, sample_weight)
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
            loss, ep = fn(features, labels, kernel, m, lam, sample_weight)
        endpoints.update(ep)
        if aux_enabled:
            loss = self._aux(loss, endpoints, features, labels, sample_weight)
        endpoints["loss"] = loss
        endpoints["labels"] = labels
        return loss, endpoints

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
                kernel = self.output_kernel
                w_norm = kernel / torch.clamp_min(
                    torch.linalg.vector_norm(kernel, dim=0, keepdim=True), EPS)
                sel_w = w_norm.t()[labels]  # [B, D]
                mhe = float(cfg["mhe_lambda"]) / (
                    row_mean(torch.mean(2.0 - 2.0 * (sel_w @ w_norm), dim=1)) + 1e-6)
                loss = loss + mhe
                endpoints["mhe_loss"] = mhe
        return loss
