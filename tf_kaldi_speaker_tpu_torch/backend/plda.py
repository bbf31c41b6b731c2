"""Two-covariance PLDA: estimation, scoring, unsupervised adaptation.

Replaces the Kaldi binaries used by the reference recipes
(``ivector-compute-plda``, ``ivector-plda-scoring``, ``ivector-adapt-plda``,
``ivector-copy-plda`` — egs/voxceleb/v1/run.sh:383-401, egs/sre/v1/run.sh:406-470).

Model (Kaldi plda.h conventions): class means y ~ N(mu, Phi_b); examples
x | y ~ N(y, Phi_w). Scoring works in the simultaneously-diagonalized space
(A Phi_w Aᵀ = I, A Phi_b Aᵀ = diag(Psi)); the verification log-likelihood
ratio for a test vector against an n-example enrollment mean follows
Kaldi's Plda::LogLikelihoodRatio closed form.

Counterpart of ``tf_kaldi_speaker_tpu/backend/plda.py``, whole (numpy
only, float64), reading Kaldi objects through the port's own ``kio``;
``tests/test_torch_scoring.py`` holds it bit-equal to the original and its
three save formats byte-equal.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..kio.ark import _read_mat_binary, _read_vec_flt_binary

M_LOG_2PI = float(np.log(2.0 * np.pi))


# ----------------------------------------------------------------------
# Kaldi <Plda> object codec primitives (src/ivector/plda.cc layout:
# WriteToken "<Plda>", Vector<double> mean, Matrix<double> transform,
# Vector<double> psi, WriteToken "</Plda>").
# ----------------------------------------------------------------------

def _expect_plda_token(fd, token: str) -> None:
    chars = []
    b = fd.read(1)
    while b in (b" ", b"\t", b"\n", b"\r"):
        b = fd.read(1)
    while b not in (b"", b" ", b"\t", b"\n", b"\r"):
        chars.append(b)
        b = fd.read(1)
    got = b"".join(chars).decode()
    if got != token:
        raise ValueError("bad Kaldi PLDA file: expected %r, got %r"
                         % (token, got))


def _write_kaldi_vec_double(fd, v: np.ndarray) -> None:
    fd.write(b"DV \04" + struct.pack("<i", v.shape[0]))
    fd.write(np.ascontiguousarray(v, "<f8").tobytes())


def _write_kaldi_mat_double(fd, m: np.ndarray) -> None:
    fd.write(b"DM \04" + struct.pack("<i", m.shape[0])
             + b"\04" + struct.pack("<i", m.shape[1]))
    fd.write(np.ascontiguousarray(m, "<f8").tobytes())


def _write_kaldi_vec_text(fd, v: np.ndarray) -> None:
    fd.write(" [ " + " ".join("%.17g" % x for x in v) + " ]\n")


def _write_kaldi_mat_text(fd, m: np.ndarray) -> None:
    fd.write(" [")
    for row in m:
        fd.write("\n  " + " ".join("%.17g" % x for x in row))
    fd.write(" ]\n")


def _text_brackets(body: str, n: int) -> List[str]:
    """The ``n`` top-level ``[ ... ]`` blocks of a Kaldi text object body."""
    blocks = []
    pos = 0
    for _ in range(n):
        start = body.index("[", pos)
        end = body.index("]", start)
        blocks.append(body[start + 1:end])
        pos = end + 1
    return blocks


@dataclass
class Plda:
    mean: np.ndarray        # [D] global mean (original space)
    transform: np.ndarray   # [D, D] diagonalizing transform A
    psi: np.ndarray         # [D] between-class variances in transformed space

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    # ------------------------------------------------------------------
    def transform_ivector(self, x: np.ndarray, num_examples: int = 1,
                          simple_length_norm: bool = False) -> Tuple[np.ndarray, float]:
        """Project into the diagonalized space with Kaldi's length scaling.

        The normalization factor makes ||scaled x||² ≈ dim under the model
        (Plda::TransformIvector / GetNormalizationFactor).
        """
        u = self.transform @ (np.asarray(x, np.float64) - self.mean)
        if simple_length_norm:
            factor = np.sqrt(self.dim) / max(np.linalg.norm(u), 1e-12)
        else:
            inv_covar = 1.0 / (self.psi + 1.0 / num_examples)
            factor = np.sqrt(self.dim / max(inv_covar @ (u * u), 1e-12))
        return u * factor, float(factor)

    def log_likelihood_ratio(
        self, transformed_enroll: np.ndarray, num_enroll: int, transformed_test: np.ndarray
    ) -> float:
        """Kaldi Plda::LogLikelihoodRatio.

        Given the mean of n enrollment vectors ū and a test vector t (both
        already transformed):
            H_same:  t ~ N( nΨ/(nΨ+I) ū,  I + Ψ/(nΨ+I) )
            H_diff:  t ~ N( 0,            I + Ψ )
        """
        n = num_enroll
        psi = self.psi
        mean = (n * psi) / (n * psi + 1.0) * transformed_enroll
        var_given = 1.0 + psi / (n * psi + 1.0)
        logdet_given = np.sum(np.log(var_given))
        sqdiff = (transformed_test - mean) ** 2
        loglike_given = -0.5 * (logdet_given + M_LOG_2PI * self.dim + np.sum(sqdiff / var_given))

        var_without = 1.0 + psi
        logdet_without = np.sum(np.log(var_without))
        sq = transformed_test**2
        loglike_without = -0.5 * (logdet_without + M_LOG_2PI * self.dim + np.sum(sq / var_without))
        return float(loglike_given - loglike_without)

    def score_trials(
        self,
        enroll: Dict[str, np.ndarray],
        enroll_counts: Dict[str, int],
        test: Dict[str, np.ndarray],
        trials: Iterable[Tuple[str, str]],
        simple_length_norm: bool = False,
    ) -> np.ndarray:
        """Batch trial scoring (ivector-plda-scoring), vectorized over trials."""
        e_keys, t_keys, score_matrix = self.score_matrix(
            enroll, enroll_counts, test, simple_length_norm
        )
        e_idx = {k: i for i, k in enumerate(e_keys)}
        t_idx = {k: i for i, k in enumerate(t_keys)}
        return np.asarray(
            [score_matrix[e_idx[e], t_idx[t]] for e, t in trials]
        )

    def score_matrix(
        self,
        enroll: Dict[str, np.ndarray],
        enroll_counts: Dict[str, int],
        test: Dict[str, np.ndarray],
        simple_length_norm: bool = False,
    ) -> Tuple[List[str], List[str], np.ndarray]:
        """All-pairs LLR scores: (sorted enroll keys, sorted test keys,
        [E, T] matrix). The dense form score_trials indexes — used directly
        for cohort scoring (AS-Norm) where every pair is needed anyway."""
        e_keys = sorted(enroll)
        t_keys = sorted(test)
        E = np.stack([
            self.transform_ivector(enroll[k], enroll_counts.get(k, 1), simple_length_norm)[0]
            for k in e_keys
        ])
        T = np.stack([
            self.transform_ivector(test[k], 1, simple_length_norm)[0] for k in t_keys
        ])
        counts = np.array([enroll_counts.get(k, 1) for k in e_keys], np.float64)

        psi = self.psi[None, :]
        n = counts[:, None]
        mean_coef = (n * psi) / (n * psi + 1.0)        # [E, D]
        var_given = 1.0 + psi / (n * psi + 1.0)        # [E, D]
        logdet_given = np.sum(np.log(var_given), axis=1)
        var_without = 1.0 + self.psi
        logdet_without = np.sum(np.log(var_without))

        # Full [E, T] score matrix with three matmuls (the quadratic form
        # Σ_d (T_jd - mc_id E_id)² / vg_id expands into i-only, j×i and
        # cross terms) — VoxCeleb-scale trial lists score in milliseconds.
        mE = mean_coef * E                              # [E, D]
        inv_vg = 1.0 / var_given                        # [E, D]
        term_i = np.sum(mE * mE * inv_vg, axis=1)       # [E]
        term_cross = (mE * inv_vg) @ T.T                # [E, T]
        term_j = inv_vg @ (T * T).T                     # [E, T]
        lg = -0.5 * (
            logdet_given[:, None] + M_LOG_2PI * self.dim
            + term_j - 2.0 * term_cross + term_i[:, None]
        )
        lw = -0.5 * (
            logdet_without + M_LOG_2PI * self.dim
            + np.sum((T * T) / var_without[None, :], axis=1)
        )                                               # [T]
        return e_keys, t_keys, lg - lw[None, :]

    # ------------------------------------------------------------------
    def smooth_within_class_covariance(self, factor: float) -> "Plda":
        """Kaldi Plda::SmoothWithinClassCovariance (``ivector-copy-plda
        --smoothing``, reference egs/voxceleb/v1/run.sh:398).

        Adds ``factor`` times the BETWEEN-class covariance to the
        within-class covariance (a per-dimension regularization: in the
        diagonalized space within_d goes 1 → 1 + factor·ψ_d), then rescales
        each transform row so the new within covariance is unit again.
        Equivalently, in the original space: Φ_w ← Φ_w + factor·Φ_b.
        """
        assert 0.0 <= factor
        within = 1.0 + factor * self.psi          # [D] smoothed within (diag space)
        psi = self.psi / within
        transform = self.transform * (within ** -0.5)[:, None]
        return Plda(mean=self.mean.copy(), transform=transform, psi=psi)

    def adapt(
        self,
        adaptation_vectors: np.ndarray,
        mean_diff_scale: float = 1.0,
        within_covar_scale: float = 0.3,
        between_covar_scale: float = 0.7,
    ) -> "Plda":
        """Unsupervised domain adaptation (Kaldi PldaUnsupervisedAdaptor /
        ivector-adapt-plda, used by the SRE16 recipe at sre run.sh:447-470).

        Follows Kaldi's ``PldaUnsupervisedAdaptor::UpdatePlda`` exactly:
        the model mean is REPLACED by the adaptation-data mean, and
        ``mean_diff_scale`` scales the outer product of the mean shift
        added to the adaptation covariance (not a mean interpolation
        factor). The covariance is projected into the space where the
        model's TOTAL covariance (within + between) is unit; along each
        eigendirection of the projected adaptation covariance, variance
        in excess of 1.0 is added to the within/between covariances with
        the configured scales; the result is re-diagonalized (Cholesky of
        the new within, then an orthogonal diagonalization of between).
        """
        x = np.asarray(adaptation_vectors, np.float64)
        dim = self.dim
        data_mean = x.mean(axis=0)
        xc = x - data_mean
        variance = xc.T @ xc / x.shape[0]
        assert mean_diff_scale >= 0.0
        mean_diff = data_mean - self.mean
        variance = variance + mean_diff_scale * np.outer(mean_diff, mean_diff)
        new_mean = data_mean.copy()

        # transform_mod: row-scaled transform that makes the model's TOTAL
        # covariance unit (within=I, between=diag(psi) → scale rows by
        # (1+psi)^-1/2).
        transform_mod = self.transform * ((1.0 + self.psi) ** -0.5)[:, None]
        variance_proj = transform_mod @ variance @ transform_mod.T
        s, P = np.linalg.eigh(variance_proj)
        order = np.argsort(s)[::-1]
        s, P = s[order], P[:, order]

        # Within/between in the space transformed by Pᵀ·transform_mod (the
        # adaptation covariance is diag(s) there; W + B = I still holds).
        W = P.T @ (((1.0 / (1.0 + self.psi))[:, None]) * P)
        B = P.T @ (((self.psi / (1.0 + self.psi))[:, None]) * P)
        excess = np.maximum(s - 1.0, 0.0)
        W[np.diag_indices(dim)] += within_covar_scale * excess
        B[np.diag_indices(dim)] += between_covar_scale * excess

        combined = P.T @ transform_mod
        # Simultaneous re-diagonalization: C⁻¹ (Cholesky of W) makes the
        # new within unit; an orthogonal Q then diagonalizes between.
        C = np.linalg.cholesky(0.5 * (W + W.T))
        Cinv = np.linalg.inv(C)
        b2 = Cinv @ B @ Cinv.T
        bvals, Q = np.linalg.eigh(0.5 * (b2 + b2.T))
        order = np.argsort(bvals)[::-1]
        new_psi = np.maximum(bvals[order], 0.0)
        new_transform = Q[:, order].T @ Cinv @ combined
        return Plda(mean=new_mean, transform=new_transform, psi=new_psi)

    # ------------------------------------------------------------------
    # Serialization.  Three interchangeable formats:
    #   npz         — numpy archive (this framework's native format)
    #   kaldi       — Kaldi binary object file: b"\0B" then the "<Plda>"
    #                 token stream (Kaldi src/ivector/plda.cc Plda::Write —
    #                 mean Vector<double>, transform Matrix<double>, psi
    #                 Vector<double>), byte-compatible with
    #                 ivector-copy-plda / ivector-plda-scoring inputs
    #                 (reference egs/voxceleb/v1/run.sh:383-401).
    #   kaldi_text  — the same object in Kaldi text mode (no \0B preamble),
    #                 what `ivector-copy-plda --binary=false` emits.
    # ``load`` sniffs the format from the file's first bytes.
    def save(self, path: str, format: str = "npz") -> None:
        if format == "npz":
            np.savez(path, mean=self.mean, transform=self.transform,
                     psi=self.psi)
        elif format == "kaldi":
            with open(path, "wb") as f:
                f.write(b"\0B<Plda> ")
                _write_kaldi_vec_double(f, self.mean)
                _write_kaldi_mat_double(f, self.transform)
                _write_kaldi_vec_double(f, self.psi)
                f.write(b"</Plda> ")
        elif format == "kaldi_text":
            with open(path, "w") as f:
                f.write("<Plda> ")
                _write_kaldi_vec_text(f, self.mean)
                _write_kaldi_mat_text(f, self.transform)
                _write_kaldi_vec_text(f, self.psi)
                f.write("</Plda> ")
        else:
            raise ValueError("unknown PLDA format %r" % format)

    @classmethod
    def load(cls, path: str) -> "Plda":
        if not path.endswith(".npz") and not os.path.exists(path) \
                and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with open(path, "rb") as f:
            magic = f.read(2)
            if magic == b"PK":               # npz is a zip archive
                z = np.load(path)
                return cls(mean=z["mean"], transform=z["transform"],
                           psi=z["psi"])
            if magic == b"\0B":              # Kaldi binary object file
                _expect_plda_token(f, "<Plda>")
                mean = _read_vec_flt_binary(f).astype(np.float64)
                transform = _read_mat_binary(f).astype(np.float64)
                psi = _read_vec_flt_binary(f).astype(np.float64)
                _expect_plda_token(f, "</Plda>")
                return cls(mean=mean, transform=transform, psi=psi)
        return cls._load_kaldi_text(path)

    @classmethod
    def _load_kaldi_text(cls, path: str) -> "Plda":
        with open(path) as f:
            text = f.read()
        if "<Plda>" not in text:
            raise ValueError("%s: not an npz / Kaldi-binary / Kaldi-text "
                             "<Plda> file" % path)
        body = text.split("<Plda>", 1)[1].split("</Plda>", 1)[0]
        blocks = _text_brackets(body, 3)
        mean = np.array(blocks[0].split(), np.float64)
        rows = [r for r in blocks[1].splitlines() if r.strip()]
        transform = np.array([r.split() for r in rows], np.float64)
        psi = np.array(blocks[2].split(), np.float64)
        return cls(mean=mean, transform=transform, psi=psi)


def train_plda(
    vectors: np.ndarray,
    labels: Sequence,
    num_em_iters: int = 10,
) -> Plda:
    """Estimate a PLDA model by EM (ivector-compute-plda equivalent).

    Args:
        vectors: [N, D] training vectors (typically length-normalized,
            LDA-projected x-vectors).
        labels: [N] class (speaker) ids.
    """
    x = np.asarray(vectors, np.float64)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    dim = x.shape[1]
    mean = x.mean(axis=0)
    xc = x - mean

    # Per-class sufficient statistics.
    counts = np.array([np.sum(labels == c) for c in classes], np.float64)
    sums = np.stack([xc[labels == c].sum(axis=0) for c in classes])
    total_scatter = xc.T @ xc

    # Init from empirical between/within scatter.
    class_means = sums / counts[:, None]
    within = np.zeros((dim, dim))
    for i, c in enumerate(classes):
        d = xc[labels == c] - class_means[i]
        within += d.T @ d
    n_total = x.shape[0]
    phi_w = within / n_total + 1e-6 * np.eye(dim)
    phi_b = (class_means * counts[:, None]).T @ class_means / n_total + 1e-6 * np.eye(dim)

    for _ in range(num_em_iters):
        inv_w = np.linalg.inv(phi_w)
        inv_b = np.linalg.inv(phi_b)
        new_b = np.zeros((dim, dim))
        e_wsum = np.zeros((dim, dim))
        for i in range(len(classes)):
            n = counts[i]
            prec = inv_b + n * inv_w
            cov_post = np.linalg.inv(prec)
            m_post = cov_post @ (inv_w @ sums[i])
            new_b += cov_post + np.outer(m_post, m_post)
            # within-stats: E[(x - y)(x - y)ᵀ] summed over the class
            e_wsum += n * cov_post - np.outer(m_post, sums[i]) - np.outer(sums[i], m_post) + n * np.outer(m_post, m_post)
        phi_b = new_b / len(classes)
        phi_w = (total_scatter + e_wsum) / n_total
        phi_b = 0.5 * (phi_b + phi_b.T) + 1e-8 * np.eye(dim)
        phi_w = 0.5 * (phi_w + phi_w.T) + 1e-8 * np.eye(dim)

    # Simultaneous diagonalization: A phi_w Aᵀ = I, A phi_b Aᵀ = diag(psi).
    wvals, wvecs = np.linalg.eigh(phi_w)
    wvals = np.maximum(wvals, 1e-10)
    w_half_inv = wvecs @ np.diag(wvals**-0.5) @ wvecs.T
    b2 = w_half_inv @ phi_b @ w_half_inv.T
    bvals, bvecs = np.linalg.eigh(b2)
    order = np.argsort(bvals)[::-1]
    psi = np.maximum(bvals[order], 0.0)
    transform = bvecs[:, order].T @ w_half_inv
    return Plda(mean=mean, transform=transform, psi=psi)
