"""Network modules (counterparts of tf_kaldi_speaker_tpu/models): the TDNN
x-vector network, ECAPA-TDNN, ResNet34 and the pooling zoo."""

from .ecapa import ECAPA
from .layers import VAR2STD_EPSILON, DenseBlock, l2_scaling
from .pooling import POOLING_REGISTRY, GhostVLAD, SelfAttentionPooling, StatisticsPooling
from .resnet import ResNet34
from .tdnn import TDNN, TDNN_TOTAL_CONTEXT, EntireNetwork, TDNNFrames, TDNNTail

__all__ = [
    "DenseBlock",
    "ECAPA",
    "EntireNetwork",
    "GhostVLAD",
    "POOLING_REGISTRY",
    "ResNet34",
    "SelfAttentionPooling",
    "StatisticsPooling",
    "TDNN",
    "TDNNFrames",
    "TDNNTail",
    "TDNN_TOTAL_CONTEXT",
    "VAR2STD_EPSILON",
    "l2_scaling",
]
