"""Back end of the port, numpy on the host: cosine/LDA/PLDA scoring,
AS-norm, calibration and the EER/minDCF/DET metrics (float64), and the ASR
decode side of the multitask recipe (``decoder``: the WFST beam decoder
over a native core; ``lattice``, ``lmrescore``, ``arpa``, ``wer``).

Counterpart of ``tf_kaldi_speaker_tpu/backend``, whose modules these are
copies of."""

from .metrics import (
    compute_cos_pairwise_eer,
    compute_eer,
    compute_min_dcf,
    det_curve,
    min_dcf08,
    min_dcf10,
    min_dcf12,
)
from .decoder import (
    DecodeResult,
    WfstDecoder,
    decode_faster_py,
    decode_lattice_py,
)
from .lattice import (
    Lattice,
    LatticeArc,
    arc_posteriors,
    best_path_confidences,
    depth_stats,
    read_lattice_ark,
    write_lattice,
)
from .plda import Plda, train_plda
from .wer import compute_wer, edit_distance, read_text_file
from .scoring import (
    LDA,
    cosine_score_trials,
    length_norm,
    read_trials,
    speaker_means,
    subtract_global_mean,
)

__all__ = [
    "DecodeResult",
    "LDA",
    "Lattice",
    "LatticeArc",
    "Plda",
    "WfstDecoder",
    "arc_posteriors",
    "best_path_confidences",
    "compute_wer",
    "decode_faster_py",
    "decode_lattice_py",
    "depth_stats",
    "edit_distance",
    "read_lattice_ark",
    "read_text_file",
    "write_lattice",
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
