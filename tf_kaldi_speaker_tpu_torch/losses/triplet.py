"""Triplet-family losses: semi-hard euclidean, angular (all/hard), GE2E-style.

Counterpart of ``tf_kaldi_speaker_tpu/losses/triplet.py`` (reference
model/loss.py:358-705). All are pure functions of (features, labels) plus
static config, with no trainable state (the generalized variant with
centers lives in :mod:`.head`). Reductions that pick a value (max, min)
are ``torch.amax``/``torch.amin``, whose gradient splits a tie evenly as
JAX's ``jnp.max``/``jnp.min`` do; floors go through ``torch.maximum``,
which splits a tie as ``jnp.maximum`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..models.layers import l2_scaling, pairwise_cos_similarity, pairwise_euc_distances
from .margin import asoftmax_phi, sparse_softmax_xent

EPS = 1e-12


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    return torch.maximum(x, torch.full_like(x, lo))


def _masked_min(data: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    amax = torch.amax(data, dim=dim, keepdim=True)
    return torch.amin((data - amax) * mask, dim=dim, keepdim=True) + amax


def _masked_max(data: torch.Tensor, mask: torch.Tensor, dim: int) -> torch.Tensor:
    amin = torch.amin(data, dim=dim, keepdim=True)
    return torch.amax((data - amin) * mask, dim=dim, keepdim=True) + amin


def semihard_triplet_loss(
    features: torch.Tensor, labels: torch.Tensor, margin: float, squared: bool = False
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """FaceNet semi-hard negative mining triplet loss (loss.py:358-498).

    For each positive pair (a, p) pick the smallest negative distance
    greater than d(a, p); if none exists use the largest negative distance.
    """
    b = features.shape[0]
    d = pairwise_euc_distances(features, squared)  # [B, B]
    adj = labels[:, None] == labels[None, :]
    adj_not = ~adj

    # For triplet (x, i): valid negatives y with d(x, y) > d(x, i).
    # mask3[i, x, y] = (label(x) != label(y)) and d(x, y) > d(x, i)
    mask3 = adj_not[None, :, :] & (d[None, :, :] > d.t()[:, :, None])
    mask3f = mask3.to(d.dtype)
    has_semihard = (torch.sum(mask3f, dim=2) > 0.0).t()  # [x, i]

    # negatives_outside[x, i]: min d(x, y) over semi-hard negatives of (x, i).
    negatives_outside = _masked_min(d[None, :, :], mask3f, dim=2)[:, :, 0].t()
    # negatives_inside[x]: max negative distance (fallback).
    negatives_inside = _masked_max(d, adj_not.to(d.dtype), dim=1)
    semi_hard = torch.where(has_semihard, negatives_outside, negatives_inside)

    loss_mat = margin + d - semi_hard
    mask_pos = adj.to(d.dtype) - torch.eye(b, dtype=d.dtype, device=d.device)
    num_pos = torch.clamp_min(torch.sum(mask_pos), 1e-16)
    loss = torch.sum(_floor(loss_mat * mask_pos, 0.0)) / num_pos
    return loss, {"loss": loss, "labels": labels}


def _positive_transform(pairwise_cos: torch.Tensor, loss_type: str, margin: float):
    """d_p transform per loss flavor (loss.py:537-560)."""
    if loss_type == "asoftmax":
        return asoftmax_phi(pairwise_cos, int(margin))
    if loss_type == "additive_margin_softmax":
        return pairwise_cos - margin
    if loss_type == "additive_angular_margin_softmax":
        shifted = pairwise_cos * math.cos(margin) - torch.sqrt(
            _floor(1.0 - pairwise_cos ** 2, 0.0)) * math.sin(margin)
        return torch.where(pairwise_cos <= math.cos(math.pi - margin), -shifted - 2.0, shifted)
    raise ValueError(loss_type)


def angular_triplet_loss(
    features: torch.Tensor,
    labels: torch.Tensor,
    margin: float,
    triplet_type: str = "all",
    loss_type: str = "additive_margin_softmax",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Online-mined angular triplet loss, "all" or "hard" (loss.py:501-634)."""
    assert triplet_type in ("all", "hard")
    b = features.shape[0]
    eps = 1e-12
    cos = pairwise_cos_similarity(features)
    eye = torch.eye(b, dtype=torch.bool, device=features.device)
    # The self-similarity is identically 1 (constant in `features`), but
    # computing it numerically makes the arc-margin sqrt(1-cos²) emit
    # inf/NaN gradients at cos = 1. Pin the diagonal to the constant.
    cos = torch.where(eye, torch.ones_like(cos), cos)
    d_p = _positive_transform(cos, loss_type, margin)
    d_n = cos
    label_eq = labels[None, :] == labels[:, None]

    if triplet_type == "all":
        # triplet (i, j, k): anchor i, positive j, negative k
        tri = d_n[:, None, :] - d_p[:, :, None]
        distinct = (~eye)[:, :, None] & (~eye)[:, None, :] & (~eye)[None, :, :]
        valid = label_eq[:, :, None] & (~label_eq)[:, None, :]
        mask = (distinct & valid).to(tri.dtype)
        tri = _floor(mask * tri, 0.0)
        num_positive = torch.sum((tri > eps).to(tri.dtype))
        loss = torch.sum(tri) / (num_positive + 1e-16)
    else:
        mask_ap = ((~eye) & label_eq).to(cos.dtype)
        max_ap = torch.amax(d_p, dim=1, keepdim=True)
        ap = d_p * mask_ap + max_ap * (1.0 - mask_ap)
        hardest_positive = torch.amin(ap, dim=1, keepdim=True)

        mask_an = (~label_eq).to(cos.dtype)
        min_ap = torch.amin(d_p, dim=1, keepdim=True)
        an = d_n * mask_an + min_ap * (1.0 - mask_an)
        hardest_negative = torch.amax(an, dim=1, keepdim=True)

        loss = torch.mean(_floor(hardest_negative - hardest_positive, 0.0))
    return loss, {"loss": loss, "labels": labels}


def e2e_valid_loss(
    features: torch.Tensor,
    labels: torch.Tensor,
    num_speakers: int,
    num_segments_per_speaker: int,
    scale: float = 20.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax generalized end-to-end loss for validation (loss.py:637-705).

    Requires features ordered speaker-major: [s1 s1 .. s2 s2 ..]. The
    similarity against a speaker's own center excludes the sample itself.
    """
    n = num_speakers * num_segments_per_speaker
    dim = features.shape[1]
    # rows beyond n_spk x n_seg are dropped before the grouped reshape
    features = l2_scaling(features[:n], 1.0)
    grouped = features.reshape(num_speakers, num_segments_per_speaker, dim)
    center = l2_scaling(torch.mean(grouped, dim=1), 1.0)
    center_ex = l2_scaling(
        (torch.sum(grouped, dim=1, keepdim=True) - grouped).reshape(n, dim), 1.0)
    similarity = features @ center.t()  # [n, num_speakers]
    similarity_ex = torch.sum(features * center_ex, dim=1)
    own = torch.arange(num_speakers, device=features.device).repeat_interleave(
        num_segments_per_speaker)
    mask = torch.nn.functional.one_hot(own, num_speakers).to(features.dtype)
    similarity = similarity * (1.0 - mask) + similarity_ex[:, None] * mask
    loss = sparse_softmax_xent(scale * similarity, own)
    return loss, {"loss": loss, "labels": labels}
