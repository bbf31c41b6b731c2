"""Scoring back end of the port (numpy, float64): cosine/LDA/PLDA scoring,
AS-norm, calibration and the EER/minDCF/DET metrics.

Counterpart of ``tf_kaldi_speaker_tpu/backend`` for the speaker-verification
back end; its decoder, lattice, LM-rescoring, ARPA and WER modules belong to
the ASR tooling and are not in the port."""

from .metrics import (
    compute_cos_pairwise_eer,
    compute_eer,
    compute_min_dcf,
    det_curve,
    min_dcf08,
    min_dcf10,
    min_dcf12,
)
from .plda import Plda, train_plda
from .scoring import (
    LDA,
    cosine_score_trials,
    length_norm,
    read_trials,
    speaker_means,
    subtract_global_mean,
)

__all__ = [
    "LDA",
    "Plda",
    "compute_cos_pairwise_eer",
    "compute_eer",
    "compute_min_dcf",
    "cosine_score_trials",
    "det_curve",
    "length_norm",
    "min_dcf08",
    "min_dcf10",
    "min_dcf12",
    "read_trials",
    "speaker_means",
    "subtract_global_mean",
    "train_plda",
]
