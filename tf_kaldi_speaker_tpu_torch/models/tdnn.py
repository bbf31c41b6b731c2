"""TDNN x-vector network with the endpoints-dict tap mechanism.

Counterpart of ``tf_kaldi_speaker_tpu/models/tdnn.py`` (reference
``model/tdnn.py:8-191``): five frame-level layers (VALID convs k5/k5/k7, then
two position-wise dense layers), each affine + BatchNorm + activation, the
pooling layer, then two utterance-level dense layers. Inputs stay [B, L, D]
and every intermediate lands in ``endpoints`` under the reference's names,
so ``embedding_node`` picks a tap unchanged. Submodules carry the JAX
package's module names (``tdnn1_conv``, ``tdnn1_bn``, ``tdnn1_prelu``, ...), so the
converter (``convert.py``) maps one tree onto the other by name.

``.train()`` / ``.eval()`` select the JAX package's ``train`` flag: in train
mode every BatchNorm normalizes with the batch's statistics and updates its
running ones (momentum ``batchnorm_momentum``, default 0.99).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .layers import BatchNorm, get_relu, init_affine_, l2_scaling
from .pooling import StatisticsPooling

# Frames of left+right context consumed by the VALID convolutions
# (k5 + k5 + k7 -> 4 + 4 + 6 frames shorter).
TDNN_TOTAL_CONTEXT = 14

CONV_LAYERS = ((1, 5), (2, 5), (3, 7))
POOLING_REGISTRY = {"statistics_pooling": StatisticsPooling}


class TDNN(nn.Module):
    """x-vector TDNN; ``forward`` returns (last_layer_output, endpoints)."""

    def __init__(self, config: Dict[str, Any], input_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        act = get_relu(cfg)
        width = cfg.get("tdnn_layer_size", 512)
        pool_width = cfg.get("num_nodes_pooling_layer", 1500)
        last_layer_no_bn = cfg.get("last_layer_no_bn", False)
        last_layer_linear = cfg.get("last_layer_linear", False)
        bn_momentum = cfg.get("batchnorm_momentum", 0.99)

        d_in = input_dim
        for i, ksize in CONV_LAYERS:
            setattr(self, "tdnn%d_conv" % i, nn.Conv1d(d_in, width, ksize))
            setattr(self, "tdnn%d_bn" % i, BatchNorm(width, bn_momentum))
            setattr(self, "tdnn%d_prelu" % i, act(width))
            d_in = width
        dense = (("tdnn4", width, width), ("tdnn5", width, pool_width),
                 ("tdnn6", 2 * pool_width, width),
                 ("tdnn7", width, cfg.get("num_nodes_last_layer", 512)))
        for name, n_in, n_out in dense:
            setattr(self, name + "_dense", nn.Linear(n_in, n_out))
            if name != "tdnn7" or not last_layer_no_bn:
                setattr(self, name + "_bn", BatchNorm(n_out, bn_momentum))
            if name != "tdnn7" or not last_layer_linear:
                setattr(self, name + "_prelu", act(n_out))

        pooling_type = cfg["pooling_type"]
        if pooling_type not in POOLING_REGISTRY:
            raise NotImplementedError(
                "%s pooling is not ported yet (ROADMAP.md §1, model zoo)" % pooling_type)
        self.pooling = POOLING_REGISTRY[pooling_type](cfg)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """glorot-uniform kernels and zero biases, drawn in layer order."""
        for i, _ in CONV_LAYERS:
            init_affine_(getattr(self, "tdnn%d_conv" % i), generator)
        for i in (4, 5, 6, 7):
            init_affine_(getattr(self, "tdnn%d_dense" % i), generator)

    def _bn_act(self, x, name, endpoints):
        bn = getattr(self, name + "_bn", None)
        if bn is not None:
            x = bn(x)
            endpoints[name + "_bn"] = x
        act = getattr(self, name + "_prelu", None)
        if act is not None:
            x = act(x)
            endpoints[name + "_relu"] = x
        return x

    def forward(
        self, features: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        endpoints: Dict[str, torch.Tensor] = {}
        x = features  # [B, L, D]
        for i, _ in CONV_LAYERS:
            name = "tdnn%d" % i
            # VALID conv over time on a [B, C, L] view of the [B, L, C] batch.
            x = getattr(self, name + "_conv")(x.transpose(1, 2)).transpose(1, 2)
            endpoints[name + "_conv"] = x
            x = self._bn_act(x, name, endpoints)

        if mask is not None:
            # A frame survives the VALID convs iff its receptive field was
            # valid; for contiguous-prefix masks the crop is exact.
            mask = mask[:, TDNN_TOTAL_CONTEXT:]

        for name in ("tdnn4", "tdnn5"):
            x = getattr(self, name + "_dense")(x)
            endpoints[name + "_dense"] = x
            x = self._bn_act(x, name, endpoints)

        x = self.pooling(x, endpoints, mask=mask)
        endpoints["pooling"] = x

        for name in ("tdnn6", "tdnn7"):
            x = getattr(self, name + "_dense")(x)
            endpoints[name + "_dense"] = x
            x = self._bn_act(x, name, endpoints)
        return x, endpoints


class EntireNetwork(nn.Module):
    """Network + optional post-hoc feature L2 re-scaling (reference
    trainer.py:168-188); the final output lands in ``endpoints["output"]``."""

    def __init__(self, config: Dict[str, Any], input_dim: int,
                 network_type: str = "tdnn",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if network_type != "tdnn":
            raise NotImplementedError(
                "network_type %r is not ported yet (ROADMAP.md §1, model zoo)"
                % network_type)
        self.config = dict(config)
        self.tdnn = TDNN(config, input_dim, generator)

    def forward(
        self, features: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out, endpoints = self.tdnn(features, mask)
        endpoints["output"] = out
        if self.config.get("feature_norm", False):
            out = l2_scaling(out, self.config["feature_scaling_factor"])
            endpoints["output"] = out
        return out, endpoints
