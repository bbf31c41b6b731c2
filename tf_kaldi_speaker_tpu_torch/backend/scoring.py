"""Embedding post-processing and trial scoring.

Replaces the Kaldi ``ivector-*`` binaries of the reference recipes
(SURVEY.md §2.4): length normalization, global-mean subtraction, per-speaker
means, cosine scoring of trial lists, and LDA estimation/transform
(run.sh:344-427).

Counterpart of ``tf_kaldi_speaker_tpu/backend/scoring.py``, whole (numpy
only, float64); ``tests/test_torch_scoring.py`` holds it bit-equal to the
original.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


def length_norm(x: np.ndarray, scale_to_sqrt_dim: bool = True) -> np.ndarray:
    """Kaldi ivector-normalize-length: scale each row to norm sqrt(dim)."""
    x = np.asarray(x, dtype=np.float64)
    norm = np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    target = np.sqrt(x.shape[-1]) if scale_to_sqrt_dim else 1.0
    return x / norm * target


def subtract_global_mean(
    x: np.ndarray, mean: np.ndarray | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Kaldi ivector-subtract-global-mean; returns (centered, mean)."""
    x = np.asarray(x, dtype=np.float64)
    if mean is None:
        mean = x.mean(axis=0)
    return x - mean, mean


def speaker_means(
    keys: Sequence[str], embeddings: np.ndarray, utt2spk: Dict[str, str]
) -> Tuple[List[str], np.ndarray, Dict[str, int]]:
    """Per-speaker mean embeddings (Kaldi ivector-mean), plus utt counts."""
    by_spk: Dict[str, List[int]] = {}
    for i, k in enumerate(keys):
        by_spk.setdefault(utt2spk[k], []).append(i)
    spks = sorted(by_spk)
    means = np.stack([embeddings[by_spk[s]].mean(axis=0) for s in spks])
    counts = {s: len(by_spk[s]) for s in spks}
    return spks, means, counts


def cosine_score_trials(
    enroll: Dict[str, np.ndarray],
    test: Dict[str, np.ndarray],
    trials: Iterable[Tuple[str, str]],
) -> np.ndarray:
    """Cosine scores for (enroll_id, test_id) trials
    (ivector-compute-dot-products on length-normalized vectors)."""
    scores = []
    for e, t in trials:
        a, b = enroll[e], test[t]
        na = max(np.linalg.norm(a), 1e-12)
        nb = max(np.linalg.norm(b), 1e-12)
        scores.append(float(a @ b / (na * nb)))
    return np.asarray(scores)


def read_trials(path: str) -> Tuple[List[Tuple[str, str]], np.ndarray]:
    """Kaldi trials file: "enroll test target|nontarget"."""
    pairs, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            pairs.append((parts[0], parts[1]))
            labels.append(1 if parts[2] == "target" else 0)
    return pairs, np.asarray(labels, np.int32)


class LDA:
    """Linear discriminant analysis, Kaldi ``ivector-compute-lda`` semantics.

    The reference recipes all call it with ``--total-covariance-factor=0.0``
    (e.g. voxceleb run.sh:378, sre run.sh:402): whiten the within-class
    covariance (interpolated toward total by the factor), diagonalize the
    projected between-class covariance, and keep the ``dim_out`` leading
    rows. The projected within-class covariance is exactly identity and the
    between-class covariance diag of the top eigenvalues — Kaldi performs NO
    further row rescaling (a previous revision whitened the projected total
    covariance too, which changes post-LDA cosine scores)."""

    def __init__(self, dim_out: int, total_covariance_factor: float = 0.0):
        self.dim_out = dim_out
        self.total_covariance_factor = total_covariance_factor
        self.transform: np.ndarray | None = None

    def fit(self, x: np.ndarray, labels: Sequence) -> "LDA":
        x = np.asarray(x, dtype=np.float64)
        labels = np.asarray(labels)
        classes = np.unique(labels)
        mean = x.mean(axis=0)
        xc = x - mean
        total_cov = xc.T @ xc / x.shape[0]
        within = np.zeros_like(total_cov)
        between = np.zeros_like(total_cov)
        for c in classes:
            xs = xc[labels == c]
            mu = xs.mean(axis=0)
            within += (xs - mu).T @ (xs - mu)
            between += len(xs) * np.outer(mu, mu)
        within /= x.shape[0]
        between /= x.shape[0]
        f = self.total_covariance_factor
        wcov = (1.0 - f) * within + f * total_cov

        # Whiten within-class covariance, then diagonalize between-class.
        evals, evecs = np.linalg.eigh(wcov)
        evals = np.maximum(evals, 1e-10)
        whiten = evecs @ np.diag(evals**-0.5) @ evecs.T
        b2 = whiten @ between @ whiten.T
        bvals, bvecs = np.linalg.eigh(b2)
        order = np.argsort(bvals)[::-1][: self.dim_out]
        self.transform = bvecs[:, order].T @ whiten
        self.mean = mean
        return self

    def transform_vecs(self, x: np.ndarray) -> np.ndarray:
        assert self.transform is not None
        return (np.asarray(x, dtype=np.float64) - self.mean) @ self.transform.T


def cosine_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, D] x [C, D] -> [N, C] cosine similarities (vectorized)."""
    an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
    bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-12)
    return an @ bn.T


def snorm_stats(
    cohort_scores: np.ndarray, topk: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row mean/std of the top-``topk`` cohort scores (all if 0).

    The top-K selection is what makes S-norm *adaptive* (AS-Norm1): each
    model is normalized against the cohort members closest to it.
    """
    s = np.asarray(cohort_scores, np.float64)
    if topk and topk < s.shape[1]:
        s = -np.partition(-s, topk - 1, axis=1)[:, :topk]
    mu = s.mean(axis=1)
    sd = np.maximum(s.std(axis=1), 1e-12)
    return mu, sd


def adaptive_snorm(
    scores: np.ndarray,
    trials: Iterable[Tuple[str, str]],
    enroll_cohort: Dict[str, Tuple[float, float]],
    test_cohort: Dict[str, Tuple[float, float]],
) -> np.ndarray:
    """Adaptive symmetric score normalization (AS-Norm).

    ``enroll_cohort``/``test_cohort`` map each side's key to its cohort
    (mean, std) from :func:`snorm_stats`. Beyond the reference's backend
    (which stops at cosine/PLDA); standard in current SV evaluation:
    s' = ((s - mu_e)/sd_e + (s - mu_t)/sd_t) / 2.
    """
    out = np.empty(len(scores), np.float64)
    for i, ((e, t), s) in enumerate(zip(trials, scores)):
        mu_e, sd_e = enroll_cohort[e]
        mu_t, sd_t = test_cohort[t]
        out[i] = 0.5 * ((s - mu_e) / sd_e + (s - mu_t) / sd_t)
    return out
