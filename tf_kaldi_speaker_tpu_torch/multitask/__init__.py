"""Multitask speaker + phone training (reference model/multitask_v1): the
port's counterpart of ``tf_kaldi_speaker_tpu/multitask``."""

from .common import make_phone_masks
from .data_v2 import (
    KaldiDataRandomQueueV2,
    KaldiDataSeqQueueV2,
    RandomChunkSamplerV2,
    SequentialChunkSamplerV2,
    get_num_phones,
    sample_with_probability,
)
from .model import MultitaskModel
from .trainer import TrainerMultiTask

__all__ = [
    "KaldiDataRandomQueueV2",
    "KaldiDataSeqQueueV2",
    "MultitaskModel",
    "RandomChunkSamplerV2",
    "SequentialChunkSamplerV2",
    "TrainerMultiTask",
    "get_num_phones",
    "make_phone_masks",
    "sample_with_probability",
]
