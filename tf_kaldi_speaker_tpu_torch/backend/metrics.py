"""Verification metrics: EER, minDCF (08/10/12), DET curves.

Replaces three external tools of the reference stack (SURVEY.md §2.4):
Kaldi ``compute-eer``, ``sid/compute_min_dcf.py`` and the MATLAB DETware
package (misc/DETware_v2.1). Pure numpy; exact sweep over score thresholds
rather than interpolation-free approximations.

Counterpart of ``tf_kaldi_speaker_tpu/backend/metrics.py``, whole (numpy
only); ``tests/test_torch_scoring.py`` and ``tests/test_torch_pool.py`` hold
it equal to the original.
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


def compute_min_dcf(
    scores: np.ndarray,
    labels: np.ndarray,
    p_target: float = 0.01,
    c_miss: float = 1.0,
    c_fa: float = 1.0,
) -> Tuple[float, float]:
    """Minimum normalized detection cost (sid/compute_min_dcf.py equivalent).

    Conventions: SRE08 uses p_target=0.01, c_miss=10, c_fa=1 (DETware
    Get_DCF); SRE10 uses p_target=0.001, c_miss=c_fa=1; minDCF12 averages
    p_target ∈ {0.01, 0.001} costs.

    Returns (normalized min cost, score threshold of the minimizing DET
    point) like the reference's sid/compute_min_dcf.py.
    """
    scores = np.asarray(scores, dtype=np.float64)
    p_miss, p_fa = det_curve(scores, labels)
    cost = c_miss * p_miss * p_target + c_fa * p_fa * (1.0 - p_target)
    idx = int(np.argmin(cost))
    denom = min(c_miss * p_target, c_fa * (1.0 - p_target))
    # DET index i corresponds to a threshold between sorted_scores[i-1]
    # and sorted_scores[i] (index 0 = accept everything).
    sorted_scores = np.sort(scores)
    thresholds = np.concatenate([[sorted_scores[0] - 1.0], sorted_scores])
    return float(cost[idx] / denom), float(thresholds[idx])


def min_dcf08(scores, labels) -> float:
    """NIST SRE08 operating point (DETware Get_DCF: Cmiss=10, Cfa=1, Pt=0.01),
    reported unnormalized like the reference's RESULTS.md numbers."""
    p_miss, p_fa = det_curve(scores, labels)
    cost = 10.0 * p_miss * 0.01 + 1.0 * p_fa * 0.99
    return float(np.min(cost))


def min_dcf10(scores, labels) -> float:
    """NIST SRE10 operating point (Cmiss=Cfa=1, Pt=0.001), normalized."""
    return compute_min_dcf(scores, labels, p_target=0.001, c_miss=1.0, c_fa=1.0)[0]


def min_dcf12(scores, labels) -> float:
    """NIST SRE12 core cost: average of Pt=0.01 and Pt=0.001 normalized DCFs."""
    a = compute_min_dcf(scores, labels, p_target=0.01)[0]
    b = compute_min_dcf(scores, labels, p_target=0.001)[0]
    return float((a + b) / 2.0)


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
