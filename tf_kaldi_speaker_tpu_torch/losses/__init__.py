"""Loss zoo of the port: the margin-softmax family, its head and the ring
and MHE auxiliary terms."""

from .head import AUX_LOSSES, LOSS_NAMES, STRUCTURAL_LOSSES, LossHead
from .margin import (
    amsoftmax_loss,
    arcsoftmax_loss,
    asoftmax_loss,
    asoftmax_phi,
    margin_annealing_lambda,
    softmax_loss,
    sparse_softmax_xent,
)

__all__ = [
    "AUX_LOSSES",
    "LOSS_NAMES",
    "STRUCTURAL_LOSSES",
    "LossHead",
    "amsoftmax_loss",
    "arcsoftmax_loss",
    "asoftmax_loss",
    "asoftmax_phi",
    "margin_annealing_lambda",
    "softmax_loss",
    "sparse_softmax_xent",
]
