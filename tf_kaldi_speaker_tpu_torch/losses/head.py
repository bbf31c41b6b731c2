"""LossHead: the trainable classification head and the loss dispatch.

Counterpart of ``tf_kaldi_speaker_tpu/losses/head.py`` for the softmax
family (softmax, A-, AM- and Arc-softmax):

- ``output_kernel`` [D, C]: the softmax/margin weight matrix, in the JAX
  package's layout (glorot-uniform init).
- ``output_bias`` [C]: plain softmax only.

Margins can be overridden at call time (``margin_override``): the trainer
neutralizes them during validation. The triplet, GE2E and
generalized-triplet losses and the ring and MHE auxiliaries are not ported
yet (ROADMAP.md §1 item 8) and raise ``NotImplementedError``.
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
        if loss_func not in SOFTMAX_FAMILY or config.get("aux_loss_func"):
            raise NotImplementedError(
                "loss %s with aux losses %s is not ported yet (ROADMAP.md §1 "
                "item 8: triplet, GE2E, ring and MHE)"
                % (loss_func, list(config.get("aux_loss_func", []))))
        self.loss_func = loss_func
        self.config = dict(config)
        self.output_kernel = nn.Parameter(torch.empty(dim, num_outputs))
        limit = math.sqrt(6.0 / (dim + num_outputs))
        with torch.no_grad():
            self.output_kernel.uniform_(-limit, limit, generator=generator)
        if loss_func == "softmax":
            self.output_bias = nn.Parameter(torch.zeros(num_outputs))

    def forward(
        self,
        features: torch.Tensor,
        labels: torch.Tensor,
        step=0,
        margin_override: Optional[float] = None,
        sample_weight: Optional[torch.Tensor] = None,
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
        endpoints["loss"] = loss
        endpoints["labels"] = labels
        return loss, endpoints
