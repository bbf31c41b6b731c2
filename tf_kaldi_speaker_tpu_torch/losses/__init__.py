"""Loss zoo of the port: the margin-softmax family, the triplet family
(semi-hard, angular, GE2E and the generalized angular triplet), their head
and the ring and MHE auxiliary terms."""

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
from .triplet import angular_triplet_loss, e2e_valid_loss, semihard_triplet_loss

__all__ = [
    "AUX_LOSSES",
    "LOSS_NAMES",
    "STRUCTURAL_LOSSES",
    "LossHead",
    "amsoftmax_loss",
    "angular_triplet_loss",
    "arcsoftmax_loss",
    "asoftmax_loss",
    "asoftmax_phi",
    "e2e_valid_loss",
    "margin_annealing_lambda",
    "semihard_triplet_loss",
    "softmax_loss",
    "sparse_softmax_xent",
]
