"""TDNN x-vector network with the endpoints-dict tap mechanism.

Counterpart of ``tf_kaldi_speaker_tpu/models/tdnn.py`` (reference
``model/tdnn.py:8-191``): five frame-level layers (VALID convs k5/k5/k7, then
two position-wise dense layers), each affine + BatchNorm + activation, the
pooling layer, then two utterance-level dense layers. Inputs stay [B, L, D]
and every intermediate lands in ``endpoints`` under the reference's names,
so ``embedding_node`` picks a tap unchanged. Submodules carry the JAX
package's module names (``tdnn1_conv``, ``tdnn1_bn``, ``tdnn1_prelu``, ...;
the pooling is named after its type, ``self_attention``, ``ghost_vlad``),
so the converter (``convert.py``) maps one tree onto the other by name.

:class:`TDNNFrames` and :class:`TDNNTail` are the two halves of a TDNN,
sharing its parameters, for the exact long-utterance extraction.
:class:`EntireNetwork` dispatches on ``network_type`` (``tdnn``,
``ecapa_tdnn``, ``resnet34``).

``.train()`` / ``.eval()`` select the JAX package's ``train`` flag: in train
mode every BatchNorm normalizes with the batch's statistics and updates its
running ones (momentum ``batchnorm_momentum``, default 0.99).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .layers import BatchNorm, get_relu, init_affine_, l2_scaling
from .pooling import make_pooling

# Frames of left+right context consumed by the VALID convolutions
# (k5 + k5 + k7 -> 4 + 4 + 6 frames shorter).
TDNN_TOTAL_CONTEXT = 14

CONV_LAYERS = ((1, 5), (2, 5), (3, 7))


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
        for name, n_in, n_out in (("tdnn4", width, width), ("tdnn5", width, pool_width)):
            setattr(self, name + "_dense", nn.Linear(n_in, n_out))
            setattr(self, name + "_bn", BatchNorm(n_out, bn_momentum))
            setattr(self, name + "_prelu", act(n_out))

        # the frame-level endpoints a pooling may tap, by width
        widths = {"tdnn%d_%s" % (i, kind): width
                  for i in (1, 2, 3, 4) for kind in ("conv", "dense", "bn", "relu")}
        widths.update({"tdnn5_" + kind: pool_width for kind in ("dense", "bn", "relu")})
        self.pooling_type = cfg["pooling_type"]
        pooling = make_pooling(cfg, pool_width, widths)
        self.add_module(self.pooling_type, pooling)

        utt = (("tdnn6", pooling.output_dim, width),
               ("tdnn7", width, cfg.get("num_nodes_last_layer", 512)))
        for name, n_in, n_out in utt:
            setattr(self, name + "_dense", nn.Linear(n_in, n_out))
            if name != "tdnn7" or not last_layer_no_bn:
                setattr(self, name + "_bn", BatchNorm(n_out, bn_momentum))
            if name != "tdnn7" or not last_layer_linear:
                setattr(self, name + "_prelu", act(n_out))
        self.output_dim = utt[-1][2]
        self.reset_parameters(generator)

    @property
    def pooling(self) -> nn.Module:
        return getattr(self, self.pooling_type)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """glorot-uniform kernels and zero biases, drawn in layer order."""
        for i, _ in CONV_LAYERS:
            init_affine_(getattr(self, "tdnn%d_conv" % i), generator)
        for i in (4, 5, 6, 7):
            init_affine_(getattr(self, "tdnn%d_dense" % i), generator)
        if hasattr(self.pooling, "reset_parameters"):
            self.pooling.reset_parameters(generator)

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

    def frames(self, features: torch.Tensor,
               endpoints: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Frame-level layers 1-5: [B, L, D] -> [B, L - 14, pool width]."""
        x = features
        for i, _ in CONV_LAYERS:
            name = "tdnn%d" % i
            # VALID conv over time on a [B, C, L] view of the [B, L, C] batch.
            x = getattr(self, name + "_conv")(x.transpose(1, 2)).transpose(1, 2)
            endpoints[name + "_conv"] = x
            x = self._bn_act(x, name, endpoints)
        for name in ("tdnn4", "tdnn5"):
            x = getattr(self, name + "_dense")(x)
            endpoints[name + "_dense"] = x
            x = self._bn_act(x, name, endpoints)
        return x

    def tail(self, pooled: torch.Tensor, endpoints: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Utterance-level layers 6-7 on the pooled vector."""
        x = pooled
        for name in ("tdnn6", "tdnn7"):
            x = getattr(self, name + "_dense")(x)
            endpoints[name + "_dense"] = x
            x = self._bn_act(x, name, endpoints)
        return x

    def forward(
        self, features: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        endpoints: Dict[str, torch.Tensor] = {}
        x = self.frames(features, endpoints)
        if mask is not None:
            # A frame survives the VALID convs iff its receptive field was
            # valid; for contiguous-prefix masks the crop is exact.
            mask = mask[:, TDNN_TOTAL_CONTEXT:]
        x = self.pooling(x, endpoints, mask=mask)
        endpoints["pooling"] = x
        return self.tail(x, endpoints), endpoints


class TDNNFrames(nn.Module):
    """Frame-level half of a :class:`TDNN` (layers 1-5), with its
    parameters: [B, L, D] -> [B, L - 14, pool width] (JAX ``TDNNFrames``,
    ``tdnn.py:133-165``). Statistics pooling is associative, so sums of
    this over overlapping chunks equal one forward over the whole input."""

    def __init__(self, tdnn: TDNN):
        super().__init__()
        self.tdnn = tdnn

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.tdnn.frames(features, {})


class TDNNTail(nn.Module):
    """Utterance-level half of a :class:`TDNN` with its parameters: the
    pooled [mean || stddev] -> the endpoints of layers 6-7 and ``output``
    (feature-norm applied as the config says; JAX ``TDNNTail``,
    ``tdnn.py:168-206``)."""

    def __init__(self, tdnn: TDNN, config: Dict[str, Any]):
        super().__init__()
        self.tdnn = tdnn
        self.config = dict(config)

    def forward(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        endpoints: Dict[str, torch.Tensor] = {"pooling": pooled}
        x = self.tdnn.tail(pooled, endpoints)
        endpoints["output"] = x
        if self.config.get("feature_norm", False):
            endpoints["output"] = l2_scaling(x, self.config["feature_scaling_factor"])
        return endpoints


# network_type -> the submodule's name (the JAX package's module name)
NETWORK_NAMES = {"tdnn": "tdnn", "ecapa_tdnn": "ecapa", "resnet34": "resnet"}


class EntireNetwork(nn.Module):
    """Network + optional post-hoc feature L2 re-scaling (reference
    trainer.py:168-188); the final output lands in ``endpoints["output"]``.
    ``network_type`` selects the trunk (JAX ``tdnn.py:209-244``), held as
    the submodule ``tdnn``, ``ecapa`` or ``resnet``; ``output_dim`` is its
    output width."""

    def __init__(self, config: Dict[str, Any], input_dim: int,
                 network_type: str = "tdnn",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if network_type == "tdnn":
            trunk = TDNN(config, input_dim, generator)
        elif network_type == "ecapa_tdnn":
            from .ecapa import ECAPA

            trunk = ECAPA(config, input_dim, generator)
        elif network_type == "resnet34":
            from .resnet import ResNet34

            trunk = ResNet34(config, input_dim, generator)
        else:
            raise NotImplementedError("Not implement %s network" % network_type)
        self.config = dict(config)
        self.network_type = network_type
        self.add_module(NETWORK_NAMES[network_type], trunk)
        self.output_dim = trunk.output_dim

    @property
    def trunk(self) -> nn.Module:
        return getattr(self, NETWORK_NAMES[self.network_type])

    def forward(
        self, features: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        out, endpoints = self.trunk(features, mask)
        endpoints["output"] = out
        if self.config.get("feature_norm", False):
            out = l2_scaling(out, self.config["feature_scaling_factor"])
            endpoints["output"] = out
        return out, endpoints
