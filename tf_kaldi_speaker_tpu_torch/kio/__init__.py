"""Kaldi ark/scp I/O for the port, numpy only: float matrices (compressed
included), raw compressed-matrix codes for the device pipe, float vectors,
r/w-specifiers, wav files and ``wav.scp``, and the data-directory
``FeatureReader``. Counterpart of
``tf_kaldi_speaker_tpu/kio`` for the formats the port reads and writes."""

from .ark import (
    ArkScpWriter,
    compress_matrix,
    decode_cm_codes,
    read_codes_scp,
    read_mat,
    read_mat_ark,
    read_mat_rspec,
    read_mat_scp,
    read_vec_flt,
    read_vec_flt_ark,
    read_vec_flt_scp,
    write_mat,
    write_vec_flt,
)
from .reader import FeatureReader
from .rspecifier import SubprocessFailed, open_or_fd, popen, read_key
from .wav import read_wav, read_wav_scp, write_wav

__all__ = [
    "ArkScpWriter",
    "FeatureReader",
    "SubprocessFailed",
    "compress_matrix",
    "decode_cm_codes",
    "open_or_fd",
    "popen",
    "read_codes_scp",
    "read_key",
    "read_mat",
    "read_mat_ark",
    "read_mat_rspec",
    "read_mat_scp",
    "read_vec_flt",
    "read_vec_flt_ark",
    "read_vec_flt_scp",
    "read_wav",
    "read_wav_scp",
    "write_mat",
    "write_vec_flt",
    "write_wav",
]
