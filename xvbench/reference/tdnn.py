"""The x-vector TDNN, plain PyTorch in float32, for deciding ``correct``.

Snyder et al., "X-vectors: robust DNN embeddings for speaker recognition",
ICASSP 2018: five frame layers (temporal convolutions of widths 5, 5, 7
without padding, then two position-wise layers), each affine, BatchNorm
and ReLU; statistics pooling (mean and standard deviation over time, the
variance floored at 1e-12); two segment layers, the last linear.
BatchNorm takes the batch's statistics, as in training, with epsilon
1e-3. The head, the L2 term and the optimizer are
in ``reference/common.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from xvbench.reference import common

BN_EPS = 1e-3
CONVS = (("tdnn1", 5), ("tdnn2", 5), ("tdnn3", 7))
CONTEXT = 14  # frames the three convolutions consume
PREFIX = "network.tdnn."


def param_spec(cfg: Dict, dim: int, classes: int) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BatchNorm statistic, in
    a fixed order; kind is "kernel", "bias", "bn_scale", "bn_bias",
    "bn_mean" or "bn_var"."""
    w = int(cfg.get("tdnn_layer_size", 512))
    pool = int(cfg.get("num_nodes_pooling_layer", 1500))
    last = int(cfg.get("num_nodes_last_layer", 512))
    layers = [(name, (w, d_in, k)) for (name, k), d_in in zip(CONVS, (dim, w, w))]
    layers += [("tdnn4", (w, w)), ("tdnn5", (pool, w)), ("tdnn6", (w, 2 * pool)),
               ("tdnn7", (last, w))]
    spec = []
    for name, shape in layers:
        kind = "conv" if len(shape) == 3 else "dense"
        spec.append((PREFIX + "%s_%s.weight" % (name, kind), shape, "kernel"))
        spec.append((PREFIX + "%s_%s.bias" % (name, kind), shape[:1], "bias"))
        for field, k in (("scale", "bn_scale"), ("bias", "bn_bias"), ("mean", "bn_mean"),
                         ("var", "bn_var")):
            spec.append((PREFIX + "%s_bn.%s" % (name, field), shape[:1], k))
    spec.append(("softmax.output_kernel", (last, classes), "kernel"))
    return spec


class Net(common.Net):
    """The TDNN over ``p``."""

    def _bn(self, x, name):
        p = self.p
        scale, bias = p[PREFIX + name + "_bn.scale"], p[PREFIX + name + "_bn.bias"]
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = ((x - mean) ** 2).mean(dim=dims)
        return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias

    def _dense(self, x, name):
        w, b = self.p[PREFIX + name + "_dense.weight"], self.p[PREFIX + name + "_dense.bias"]
        return self.q(x) @ self.q(w).t() + b

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, dim] -> [B, T - 14, pool width]."""
        h = x.transpose(1, 2)
        for name, _ in CONVS:
            w = self.p[PREFIX + name + "_conv.weight"]
            h = F.conv1d(self.q(h), self.q(w), self.p[PREFIX + name + "_conv.bias"])
            h = torch.relu(self._bn(h.transpose(1, 2), name)).transpose(1, 2)
        h = h.transpose(1, 2)
        for name in ("tdnn4", "tdnn5"):
            h = torch.relu(self._bn(self._dense(h, name), name))
        return h

    def segment(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        x6 = self._dense(pooled, "tdnn6")
        h = torch.relu(self._bn(x6, "tdnn6"))
        out = self._bn(self._dense(h, "tdnn7"), "tdnn7")  # the last layer is linear
        return {"tdnn6_dense": x6, "output": out}

