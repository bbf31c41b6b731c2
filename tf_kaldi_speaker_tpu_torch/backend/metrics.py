"""Verification metrics for validation: DET curve, EER, pairwise cosine EER.

A copy of ``det_curve``, ``compute_eer`` and ``compute_cos_pairwise_eer``
from ``tf_kaldi_speaker_tpu/backend/metrics.py`` (numpy only; the rest of
that module, minDCF and the scoring back end, is not on the port's path
yet). ``tests/test_torch_pool.py`` holds them equal to the originals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def det_curve(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """False-negative and false-positive rates over all score thresholds.

    Args:
        scores: [N] higher = more likely target.
        labels: [N] 1 for target trials, 0 for nontarget.
    Returns:
        (p_miss, p_fa), each [N+1], as the threshold sweeps low→high.
        Equivalent information to DETware's Compute_DET.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(scores, kind="mergesort")
    sorted_labels = labels[order]
    n_target = max(int(sorted_labels.sum()), 1)
    n_nontarget = max(int((~sorted_labels).sum()), 1)
    # Threshold just below the lowest score: accept everything.
    p_miss = np.concatenate([[0.0], np.cumsum(sorted_labels) / n_target])
    p_fa = np.concatenate([[1.0], 1.0 - np.cumsum(~sorted_labels) / n_nontarget])
    return p_miss, p_fa


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
    """Equal error rate and its threshold (Kaldi compute-eer equivalent).

    Interpolates the p_miss/p_fa crossing like the reference's
    brentq-over-interp1d (misc/utils.py:303) instead of snapping to the
    nearest DET point, so the returned threshold is consistent with the
    EER value (DET index i corresponds to a threshold between
    sorted_scores[i-1] and sorted_scores[i])."""
    scores = np.asarray(scores, dtype=np.float64)
    p_miss, p_fa = det_curve(scores, labels)
    diff = p_miss - p_fa  # nondecreasing: -1 .. +1
    k = int(np.argmax(diff >= 0.0))
    sorted_scores = np.sort(scores)
    # Threshold of DET index i sits just above sorted_scores[i-1].
    thresholds = np.concatenate([[sorted_scores[0] - 1.0], sorted_scores])
    if k == 0 or diff[k] <= 0.0:
        return float((p_miss[k] + p_fa[k]) / 2.0), float(thresholds[k])
    frac = -diff[k - 1] / (diff[k] - diff[k - 1])
    eer = p_miss[k - 1] + frac * (p_miss[k] - p_miss[k - 1])
    thresh = thresholds[k - 1] + frac * (thresholds[k] - thresholds[k - 1])
    return float(eer), float(thresh)


def compute_cos_pairwise_eer(
    embeddings: np.ndarray, labels: np.ndarray, max_pairs: Optional[int] = None
) -> float:
    """Cosine EER over all embedding pairs (reference misc/utils.py:273-312).

    Used after every validation pass to drive LR decisions. Vectorized; the
    reference loops in Python over O(N²) pairs.
    """
    emb = np.asarray(embeddings, dtype=np.float64)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    n = emb.shape[0]
    sim = emb @ emb.T
    iu = np.triu_indices(n, k=1)
    scores = sim[iu]
    labels = np.asarray(labels)
    is_target = (labels[iu[0]] == labels[iu[1]]).astype(np.int32)
    if max_pairs is not None and scores.shape[0] > max_pairs:
        rng = np.random.RandomState(0)
        # Keep all targets (rare); subsample nontargets.
        keep = rng.rand(scores.shape[0]) < max_pairs / scores.shape[0]
        keep |= is_target.astype(bool)
        scores, is_target = scores[keep], is_target[keep]
    eer, _ = compute_eer(scores, is_target)
    return eer
