"""Model FLOPs of the x-vector TDNN (``configs/tdnn_xvector_vox2.json``),
from shapes: two operations a multiply-add of every convolution and
product; element-wise work (BatchNorm, activations, pooling, the softmax)
is not counted. A training step counts the forward, the gradient of every
layer's input but the features', and every kernel's gradient: three times
the forward, less the first convolution's input gradient, which is never
computed. Nothing is counted twice for recomputation.
"""

from __future__ import annotations

import numpy as np

CONVS = ((4, 5), (8, 5), (14, 7))  # (frames consumed so far, kernel width)


def _widths(cfg):
    return (int(cfg.get("tdnn_layer_size", 512)), int(cfg.get("num_nodes_pooling_layer", 1500)),
            int(cfg.get("num_nodes_last_layer", 512)))


def forward(cfg, dim: int, frames):
    """The network's forward over utterances of ``frames`` input frames
    (an int or an array: the sum over them), the head left out."""
    w, pool, last = _widths(cfg)
    t = np.asarray(frames, np.float64)
    out = 0.0
    d_in = dim
    for used, k in CONVS:
        out = out + 2.0 * (t - used) * k * d_in * w
        d_in = w
    t3 = t - CONVS[-1][0]
    out = out + 2.0 * t3 * (w * w + w * pool) + 2.0 * (2 * pool * w + w * last)
    return float(np.sum(out))


def train_step(cfg, dim: int, classes: int, batch: int, length: int) -> float:
    """One training step on ``batch`` chunks of ``length`` frames with an
    additive-margin softmax over ``classes``."""
    w, _, last = _widths(cfg)
    fwd = batch * forward(cfg, dim, length) + 2.0 * batch * last * classes
    return 3.0 * fwd - 2.0 * batch * (length - CONVS[0][0]) * CONVS[0][1] * dim * w
