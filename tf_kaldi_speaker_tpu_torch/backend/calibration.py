"""Score calibration: linear logistic regression, Cllr/minCllr, actual DCF.

Beyond-reference production subsystem. The reference stack (and Kaldi's
sid/ recipes) stops at *minimum* DCF — the cost at the oracle threshold —
which overstates deployment quality: a fielded verifier must pick its
threshold *before* seeing the evaluation labels. The standard remedy
(BOSARIS toolkit / NIST SRE practice) is to map raw scores to calibrated
log-likelihood ratios with a monotone affine transform trained on a held-out
dev set, then decide at the Bayes threshold of the operating point. This
module provides that stack in pure numpy:

- ``logistic_calibration``: BOSARIS-style linear logistic regression
  (llr = a*s + b), trained by Newton iteration on the prior-weighted
  cross-entropy (equivalently: minimizes Cllr of the calibrated scores at
  the chosen training prior). ``a`` is constrained positive implicitly by
  the data (a monotone score), not by clipping.
- ``cllr``: the log-likelihood-ratio cost (Brummer & du Preez 2006), the
  proper scoring rule that measures calibration + discrimination together.
- ``min_cllr``: the discrimination-only floor of Cllr, via the PAV
  (pool-adjacent-violators) optimal monotone recalibration.
- ``actual_dcf``: normalized detection cost when deciding at the Bayes
  threshold implied by (p_target, c_miss, c_fa) — compare against
  ``metrics.compute_min_dcf`` to read off the calibration loss.

No counterpart exists in the reference recipes (eval stops at compute-eer +
DETware minDCF, egs/voxceleb/v1/run.sh:353-365); kept API-consistent with
``backend/metrics.py`` (scores: higher = target; labels: 1 target / 0 non).

Counterpart of ``tf_kaldi_speaker_tpu/backend/calibration.py``, whole;
``tests/test_torch_scoring.py`` holds it bit-equal to the original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _split(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    if scores.shape != labels.shape or scores.ndim != 1:
        raise ValueError("scores/labels must be 1-D arrays of equal length")
    tar = scores[labels]
    non = scores[~labels]
    if tar.size == 0 or non.size == 0:
        raise ValueError("need at least one target and one nontarget trial")
    return tar, non


def _softplus(x: np.ndarray) -> np.ndarray:
    """log(1 + e^x), overflow-safe."""
    return np.logaddexp(0.0, x)


def cllr(scores: np.ndarray, labels: np.ndarray) -> float:
    """Log-likelihood-ratio cost of scores *interpreted as LLRs* (bits).

    Cllr = 1/(2 ln 2) * [ mean_tar softplus(-llr) + mean_non softplus(llr) ].
    A hard-wired llr=0 system scores exactly 1.0 bit; a perfectly
    calibrated, perfectly discriminating system approaches 0."""
    tar, non = _split(scores, labels)
    c = _softplus(-tar).mean() + _softplus(non).mean()
    return float(c / (2.0 * np.log(2.0)))


def pav(y: np.ndarray, weights: np.ndarray | None = None) -> np.ndarray:
    """Pool-adjacent-violators: the nondecreasing fit minimizing weighted
    squared error to ``y``. Standard stack-of-blocks algorithm, O(n)."""
    y = np.asarray(y, dtype=np.float64)
    w = np.ones_like(y) if weights is None else np.asarray(weights, dtype=np.float64)
    if y.shape != w.shape or y.ndim != 1:
        raise ValueError("y/weights must be 1-D arrays of equal length")
    # Each block: (mean, weight, count). Merge while the tail decreases.
    means = np.empty_like(y)
    wsum = np.empty_like(y)
    count = np.empty(y.shape, dtype=np.int64)
    top = 0
    for i in range(y.size):
        means[top], wsum[top], count[top] = y[i], w[i], 1
        while top > 0 and means[top - 1] >= means[top]:
            tot = wsum[top - 1] + wsum[top]
            means[top - 1] = (
                means[top - 1] * wsum[top - 1] + means[top] * wsum[top]
            ) / tot
            wsum[top - 1] = tot
            count[top - 1] += count[top]
            top -= 1
        top += 1
    return np.repeat(means[:top], count[:top])


def min_cllr(scores: np.ndarray, labels: np.ndarray) -> float:
    """Discrimination-only Cllr floor: Cllr after the PAV-optimal monotone
    recalibration of the scores (BOSARIS minCllr).

    The PAV fit of the 0/1 labels against score order gives the optimal
    monotone posterior p(target | score) at the empirical prior; converting
    to LLRs divides out the prior odds. Ties in p (0 or 1 blocks) are kept
    finite via the standard epsilon-free route: softplus of +/-inf is
    computed piecewise (0 contribution where the block is pure and on the
    correct side)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    tar, non = _split(scores, labels)
    order = np.argsort(scores, kind="mergesort")
    y = labels[order].astype(np.float64)
    p = pav(y)
    prior_logodds = np.log(tar.size / non.size)
    with np.errstate(divide="ignore"):
        llr = np.log(p) - np.log1p(-p) - prior_logodds
    lab_sorted = labels[order]
    t = llr[lab_sorted]
    n = llr[~lab_sorted]
    # softplus(-inf) = 0 exactly: pure blocks on the correct side (targets
    # in a p==1 block, nontargets in p==0) contribute nothing. A trial
    # inside a pure block of the WRONG side (possible only with exactly
    # tied scores at the extremes) would cost +inf; guard to huge-finite so
    # the metric stays orderable.
    ct = np.where(np.isneginf(t), 1e300, _softplus(-t)).mean()
    cn = np.where(np.isposinf(n), 1e300, _softplus(n)).mean()
    return float((ct + cn) / (2.0 * np.log(2.0)))


def logistic_calibration(
    scores: np.ndarray,
    labels: np.ndarray,
    prior: float = 0.5,
    max_iter: int = 100,
    tol: float = 1e-10,
) -> Tuple[float, float]:
    """Train llr = a*scores + b by prior-weighted logistic regression.

    Minimizes the BOSARIS objective
        C(a,b) = pi/N_t * sum_tar softplus(-(a s + b + logit pi))
               + (1-pi)/N_n * sum_non softplus(a s + b + logit pi)
    (proportional to Cllr at effective prior ``prior``) with damped Newton
    iteration; the objective is convex so this converges globally.

    Returns:
        (a, b) such that calibrated LLR = a * score + b.
    """
    tar, non = _split(scores, labels)
    if not 0.0 < prior < 1.0:
        raise ValueError("prior must be in (0, 1)")
    logit_pi = np.log(prior / (1.0 - prior))
    x = np.concatenate([tar, non])
    y = np.concatenate([np.ones(tar.size), np.zeros(non.size)])
    wt = np.where(y > 0.5, prior / tar.size, (1.0 - prior) / non.size)

    a, b = 1.0, 0.0
    prev = np.inf
    for _ in range(max_iter):
        z = a * x + b + logit_pi
        obj = float(np.sum(wt * np.where(y > 0.5, _softplus(-z), _softplus(z))))
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -500, 500)))
        # Gradient of C wrt (a, b)
        r = wt * (p - y)
        g = np.array([np.sum(r * x), np.sum(r)])
        h = wt * p * (1.0 - p)
        H = np.array(
            [[np.sum(h * x * x), np.sum(h * x)], [np.sum(h * x), np.sum(h)]]
        )
        # Damped Newton with Levenberg fallback for near-singular H
        lam = 0.0
        for _damp in range(50):
            try:
                da, db = np.linalg.solve(H + lam * np.eye(2), -g)
            except np.linalg.LinAlgError:
                lam = max(lam * 10.0, 1e-12)
                continue
            z2 = (a + da) * x + (b + db) + logit_pi
            obj2 = float(
                np.sum(wt * np.where(y > 0.5, _softplus(-z2), _softplus(z2)))
            )
            if obj2 <= obj + 1e-15:
                a, b = a + da, b + db
                break
            lam = max(lam * 10.0, 1e-8)
        if abs(prev - obj) < tol * max(1.0, abs(obj)):
            break
        prev = obj
    return float(a), float(b)


def apply_calibration(scores: np.ndarray, a: float, b: float) -> np.ndarray:
    """Map raw scores to calibrated LLRs."""
    return a * np.asarray(scores, dtype=np.float64) + b


def bayes_threshold(
    p_target: float, c_miss: float = 1.0, c_fa: float = 1.0
) -> float:
    """LLR decision threshold minimizing Bayes risk at an operating point:
    accept iff llr >= log((1-p) c_fa / (p c_miss))."""
    if not 0.0 < p_target < 1.0:
        raise ValueError("p_target must be in (0, 1)")
    return float(np.log(((1.0 - p_target) * c_fa) / (p_target * c_miss)))


def actual_dcf(
    llrs: np.ndarray,
    labels: np.ndarray,
    p_target: float,
    c_miss: float = 1.0,
    c_fa: float = 1.0,
) -> float:
    """Normalized detection cost at the Bayes threshold (actDCF).

    Same normalization as ``metrics.compute_min_dcf`` (divide by
    min(p c_miss, (1-p) c_fa)); with well-calibrated LLRs actDCF ~= minDCF,
    and the gap between them is the calibration loss at that operating
    point."""
    tar, non = _split(llrs, labels)
    t = bayes_threshold(p_target, c_miss, c_fa)
    p_miss = float(np.mean(tar < t))
    p_fa = float(np.mean(non >= t))
    cost = p_target * c_miss * p_miss + (1.0 - p_target) * c_fa * p_fa
    return float(cost / min(p_target * c_miss, (1.0 - p_target) * c_fa))
