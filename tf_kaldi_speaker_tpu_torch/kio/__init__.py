"""Kaldi ark/scp I/O for the port, numpy only: float matrices (compressed
included), raw compressed-matrix codes for the device pipe, float vectors,
int vectors (alignments) and posteriors, r/w-specifiers, wav files and
``wav.scp``, the data-directory ``FeatureReader``, the multitask
path's ``FeatureReaderV2``, the OpenFst codec of decoding graphs and TF1
TensorBundle checkpoints (``tf_bundle``). Counterpart of
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
    read_post,
    read_post_ark,
    read_vec_flt,
    read_vec_flt_ark,
    read_vec_flt_scp,
    read_vec_int,
    read_vec_int_ark,
    write_mat,
    write_post,
    write_vec_flt,
    write_vec_int,
)
from .fst import StdFst, build_fst, read_fst, read_words_txt, write_fst
from .reader import FeatureReader, FeatureReaderV2
from .rspecifier import SubprocessFailed, open_or_fd, popen, read_key
from .tf_bundle import read_tf_checkpoint, write_tf_checkpoint
from .wav import read_wav, read_wav_scp, write_wav

__all__ = [
    "ArkScpWriter",
    "FeatureReader",
    "FeatureReaderV2",
    "StdFst",
    "SubprocessFailed",
    "build_fst",
    "compress_matrix",
    "decode_cm_codes",
    "open_or_fd",
    "popen",
    "read_codes_scp",
    "read_fst",
    "read_key",
    "read_mat",
    "read_mat_ark",
    "read_mat_rspec",
    "read_mat_scp",
    "read_post",
    "read_post_ark",
    "read_tf_checkpoint",
    "read_vec_flt",
    "read_vec_flt_ark",
    "read_vec_flt_scp",
    "read_vec_int",
    "read_vec_int_ark",
    "read_wav",
    "read_wav_scp",
    "read_words_txt",
    "write_fst",
    "write_mat",
    "write_post",
    "write_tf_checkpoint",
    "write_vec_flt",
    "write_vec_int",
    "write_wav",
]
