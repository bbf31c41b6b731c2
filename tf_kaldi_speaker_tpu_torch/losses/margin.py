"""Margin-softmax family: softmax, A-softmax, AM-softmax, AAM (Arc) softmax.

Counterpart of ``tf_kaldi_speaker_tpu/losses/margin.py`` (reference
``model/loss.py:9-355``), with its numerics: the Chebyshev phi for
A-softmax m in {1, 2, 4}, the theta + m > pi branch of ArcFace, and the
lambda annealing blend ``fs * logits + fa * logits_margin`` with
lambda = max(lambda_min, base * (1 + gamma * step)^(-power)).

All functions are pure: (features [B, D], labels [B], kernel [D, C], ...)
-> (loss scalar, endpoints dict). The kernel is the ``output_kernel``
parameter of :class:`~tf_kaldi_speaker_tpu_torch.losses.head.LossHead`.
Clipping goes through ``torch.maximum`` / ``torch.minimum``, whose gradient
splits at a tie as ``jnp.clip``'s does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

EPS = 1e-12


def sparse_softmax_xent(
    logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean sparse softmax cross-entropy (tf.losses semantics).

    ``weights`` [B] (optional) is a row-validity weight: the mean is taken
    over sum(weights) instead of B, so rows padded for device-count
    alignment (weight 0) do not bias the loss."""
    logz = torch.logsumexp(logits, dim=-1)
    sel = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    per_row = logz - sel
    if weights is None:
        return torch.mean(per_row)
    weights = weights.to(per_row.dtype)
    return torch.sum(per_row * weights) / torch.clamp_min(torch.sum(weights), EPS)


def margin_annealing_lambda(
    step, lambda_min: float, lambda_base: float, lambda_gamma: float, lambda_power: float
) -> torch.Tensor:
    """lambda(step) schedule shared by all margin losses (loss.py:144-152):
    a float32 scalar on the CPU, which combines with tensors on any device
    and costs the card no copy."""
    step = torch.as_tensor(step, dtype=torch.float32)
    return torch.clamp_min(
        lambda_base * (1.0 + lambda_gamma * step) ** (-lambda_power), float(lambda_min))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: maximum, then minimum, each splitting a tie's gradient.
    The bounds are filled on x's device (a tensor made from a Python value
    there would be a host copy that waits for the device)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _normalized_logits(features: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """logits against column-normalized weights."""
    norm = torch.linalg.vector_norm(kernel, dim=0, keepdim=True)
    return features @ (kernel / torch.clamp_min(norm, EPS))


def _target_cos(logits, features, labels):
    sel = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    fnorm = torch.clamp_min(torch.linalg.vector_norm(features, dim=1), EPS)
    cos = _clip(sel / fnorm, -1 + EPS, 1 - EPS)
    return sel, fnorm, cos


def _blend(logits, labels, sel, scaled, lam):
    """fs * logits + fa * (logits with the target replaced by ``scaled``), in
    the type that JAX promotes logits and the float32 lambda to."""
    fa = 1.0 / (1.0 + lam)
    fs = 1.0 - fa
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.long()[:, None] == classes).to(logits.dtype)
    logits_margin = logits + onehot * (scaled - sel)[:, None]
    dtype = torch.promote_types(logits.dtype, lam.dtype)
    return fs * logits.to(dtype) + fa * logits_margin.to(dtype)


def softmax_loss(
    features, labels, kernel, bias, weights=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Vanilla softmax with an affine output layer (loss.py:9-48)."""
    logits = features @ kernel + bias
    return sparse_softmax_xent(logits, labels, weights), {"logits": logits, "labels": labels}


def asoftmax_phi(cos: torch.Tensor, m: int) -> torch.Tensor:
    """SphereFace Phi(theta, m) via the Chebyshev sign trick (loss.py:129-139)."""
    if m == 1:
        return cos
    if m == 2:
        return 2.0 * torch.sign(cos) * torch.square(cos) - 1.0
    if m == 4:
        cos2 = torch.square(cos)
        cos4 = cos2 * cos2
        sign0 = torch.sign(cos)
        sign3 = torch.sign(2.0 * cos2 - 1.0) * sign0
        sign4 = 2.0 * sign0 + sign3 - 3.0
        return sign3 * (8.0 * cos4 - 8.0 * cos2 + 1.0) + sign4
    raise NotImplementedError("[ERROR] m=%d is not supported." % m)


def asoftmax_loss(features, labels, kernel, m: int, lam, weights=None):
    """Angular (Sphere) softmax (loss.py:51-169)."""
    logits = _normalized_logits(features, kernel)
    if m == 1:
        return sparse_softmax_xent(logits, labels, weights), {"logits": logits, "labels": labels}
    sel, fnorm, cos = _target_cos(logits, features, labels)
    scaled = asoftmax_phi(cos, m) * fnorm
    updated = _blend(logits, labels, sel, scaled, lam)
    return sparse_softmax_xent(updated, labels, weights), {"logits": logits, "labels": labels}


def amsoftmax_loss(features, labels, kernel, m: float, lam, weights=None):
    """Additive-margin softmax: ||x|| (cos theta - m) (loss.py:172-257)."""
    logits = _normalized_logits(features, kernel)
    sel, fnorm, cos = _target_cos(logits, features, labels)
    scaled = (cos - m) * fnorm
    updated = _blend(logits, labels, sel, scaled, lam)
    return sparse_softmax_xent(updated, labels, weights), {"logits": logits, "labels": labels}


def arcsoftmax_loss(features, labels, kernel, m: float, lam, weights=None):
    """Additive angular margin (ArcFace): ||x|| cos(theta + m) (loss.py:260-355)."""
    logits = _normalized_logits(features, kernel)
    sel, fnorm, cos = _target_cos(logits, features, labels)
    sin = torch.sqrt(torch.clamp_min(1.0 - torch.square(cos), 1e-12))
    cos_m = cos * math.cos(m) - sin * math.sin(m)
    # theta + m > pi  <=>  cos theta < cos(pi - m): the monotone extension.
    phi = torch.where(cos > math.cos(math.pi - m), cos_m, -cos_m - 2.0)
    scaled = phi * fnorm
    updated = _blend(logits, labels, sel, scaled, lam)
    return sparse_softmax_xent(updated, labels, weights), {"logits": logits, "labels": labels}
