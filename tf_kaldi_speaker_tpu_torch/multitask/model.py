"""Multitask speaker+phone model: shared trunk, two branch encoders, two heads.

Counterpart of ``tf_kaldi_speaker_tpu/multitask/model.py`` (reference
model/multitask_v1/tdnn.py + base_v1.py):

- speaker encoder = x-vector TDNN (conv5/conv5/conv7/dense/dense->1500,
  BatchNorm + ReLU each), sliced to the un-expanded frames
  (``x[:, lc-7 : L-(rc-7)]``, tdnn.py:135-140), masked statistics pooling
  with the two-pass ``masked_moments`` and ``floor_sqrt`` (not the fused
  kernel: the JAX model pools so too), ``dense6``/``bn6``, and the speaker
  embedding layer ``zs_dense`` (+ ``zs_bn`` unless
  ``spk_last_layer_no_bn``, + ReLU unless ``spk_last_layer_linear``);
- phone encoder = config-driven TDNN (``phone_kernel_size`` /
  ``phone_layer_size`` / ``phone_dilation_size``; dilated VALID convs, a
  kernel of 1 a dense layer) sharing the first ``num_shared_layers`` with
  the speaker encoder (tdnn.py:244-278), then ``zp_dense``/``zp_bn``/ReLU;
- joint loss = ``spk_loss_weight``·L_spk + ``phn_loss_weight``·L_phn
  (base_v1.py:446-447); the phone loss on a [B, K] frame subset
  (``phn_mask_idx``) or, with ``phn_mask_idx`` None, on every frame weighted
  by its validity under ``feat_length`` (and the row weight).

The shared prefix runs once and feeds both branches, so its BatchNorms get
one statistics update a step (the JAX design; TF re-runs the prefix under
variable-scope reuse). Submodules carry the JAX module names (``conv1``,
``bn1``, ..., ``phn_conv5``, ``zs_dense``, ``spk_softmax``,
``phn_softmax``) and endpoints the JAX endpoint names, so ``convert.py``
maps the JAX variable tree onto this module and tests compare endpoints one
by one. Train or eval mode is the module's ``.training``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..losses import LossHead
from ..models.layers import BatchNorm, init_affine_
from ..models.pooling import floor_sqrt, masked_moments
from ..utils.params import ParamsPlain, remove_params_prefix

# Speaker-encoder trunk spec: (kind, width, kernel, dilation) per layer; a
# width of None is num_nodes_pooling_layer, 512 is tdnn_layer_size.
SPEAKER_LAYERS = (
    ("conv", 512, 5, 1),
    ("conv", 512, 5, 1),
    ("conv", 512, 7, 1),
    ("dense", 512, 1, 1),
    ("dense", None, 1, 1),
)
SPEAKER_LEFT_CONTEXT = 7
SPEAKER_RIGHT_CONTEXT = 7


def _relu(cfg: Dict[str, Any]):
    if cfg.get("network_relu_type", "relu") == "lrelu":
        return F.leaky_relu
    return F.relu


def _layer_name(kind: str, i: int, prefix: str = "") -> str:
    return "%s%s%d" % (prefix, "conv" if kind == "conv" else "dense", i + 1)


def _affine(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv over time on a [B, C, L] view of the [B, L, C] batch, or a
    position-wise dense layer."""
    if isinstance(layer, nn.Conv1d):
        return layer(x.transpose(1, 2)).transpose(1, 2)
    return layer(x)


class MultitaskModel(nn.Module):
    """``forward`` returns (loss, endpoints); :meth:`predict_speaker` and
    :meth:`predict_phone` are the eval-mode embedding and log-posterior
    paths (call them under ``.eval()``)."""

    def __init__(self, config: Dict[str, Any], num_speakers: int, num_phones: int,
                 input_dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = dict(config)
        width = cfg.get("tdnn_layer_size", 512)
        pool_width = cfg.get("num_nodes_pooling_layer", 1500)
        momentum = cfg.get("batchnorm_momentum", 0.99)

        # ---- speaker trunk
        d_in, out_widths = input_dim, []
        for i, (kind, w, k, d) in enumerate(SPEAKER_LAYERS):
            w = pool_width if w is None else width
            layer = nn.Conv1d(d_in, w, k) if kind == "conv" else nn.Linear(d_in, w)
            self.add_module(_layer_name(kind, i), layer)
            self.add_module("bn%d" % (i + 1), BatchNorm(w, momentum))
            out_widths.append(w)
            d_in = w
        self.dense6 = nn.Linear(2 * pool_width, width)
        self.bn6 = BatchNorm(width, momentum)
        speaker_dim = cfg.get("speaker_dim", 512)
        self.zs_dense = nn.Linear(width, speaker_dim)
        if not cfg.get("spk_last_layer_no_bn", False):
            self.zs_bn = BatchNorm(speaker_dim, momentum)

        # ---- phone branch (unshared part)
        self.num_shared = int(cfg.get("num_shared_layers", 0))
        pk = list(cfg["phone_kernel_size"])
        pl = list(cfg["phone_layer_size"])
        pd = list(cfg.get("phone_dilation_size", [1] * len(pk)))
        assert self.num_shared < len(pk)
        for i in range(self.num_shared):
            kind, w, k, d = SPEAKER_LAYERS[i]
            assert pk[i] == k and pd[i] == d, (
                "shared layer %d spec mismatch: speaker (k=%d,d=%d) vs phone (k=%d,d=%d)"
                % (i, k, d, pk[i], pd[i])
            )
        self.phone_spec = list(zip(pk, pl, pd))
        d_in = out_widths[self.num_shared - 1] if self.num_shared else input_dim
        for i in range(self.num_shared, len(pk)):
            if pk[i] > 1:
                layer = nn.Conv1d(d_in, pl[i], pk[i], dilation=pd[i])
            else:
                layer = nn.Linear(d_in, pl[i])
            self.add_module(_layer_name("conv" if pk[i] > 1 else "dense", i, "phn_"), layer)
            self.add_module("phn_bn%d" % (i + 1), BatchNorm(pl[i], momentum))
            d_in = pl[i]
        phone_dim = cfg.get("phone_dim", 512)
        self.zp_dense = nn.Linear(d_in, phone_dim)
        self.zp_bn = BatchNorm(phone_dim, momentum)

        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)):
                init_affine_(module, generator)

        # ---- loss heads
        spk_cfg = remove_params_prefix(ParamsPlain(**cfg), "spk").dict
        phn_cfg = remove_params_prefix(ParamsPlain(**cfg), "phn").dict
        self.spk_softmax = LossHead(cfg.get("spk_loss_type", "softmax"), num_speakers,
                                    spk_cfg, speaker_dim, generator)
        self.phn_softmax = LossHead(cfg.get("phn_loss_type", "softmax"), num_phones,
                                    phn_cfg, phone_dim, generator)

    # ------------------------------------------------------------------
    def _shared_prefix(self, x, endpoints):
        relu = _relu(self.config)
        for i in range(self.num_shared):
            x = _affine(getattr(self, _layer_name(SPEAKER_LAYERS[i][0], i)), x)
            x = relu(getattr(self, "bn%d" % (i + 1))(x))
            endpoints["shared%d" % (i + 1)] = x
        return x

    def _speaker_branch(self, x, feat_length, endpoints):
        cfg = self.config
        relu = _relu(cfg)
        lc = int(cfg["phone_left_context"])
        rc = int(cfg["phone_right_context"])
        for i in range(self.num_shared, 5):
            name = _layer_name(SPEAKER_LAYERS[i][0], i)
            x = _affine(getattr(self, name), x)
            endpoints[name] = x
            x = getattr(self, "bn%d" % (i + 1))(x)
            endpoints["bn%d" % (i + 1)] = x
            x = relu(x)
            endpoints["relu%d" % (i + 1)] = x

        # Context slicing (tdnn.py:135-140): the input was expanded by the
        # (larger) phone context; trim to the un-expanded frames.
        if lc < SPEAKER_LEFT_CONTEXT or rc < SPEAKER_RIGHT_CONTEXT:
            raise NotImplementedError("phone context must dominate the speaker context")
        x = x[:, lc - SPEAKER_LEFT_CONTEXT : x.shape[1] - (rc - SPEAKER_RIGHT_CONTEXT), :]

        # Masked statistics pooling (multitask_v1/pooling.py:9-40).
        frames = torch.arange(x.shape[1], device=x.device)
        mask = (frames[None, :] < feat_length[:, None]).to(x.dtype)
        mean, var = masked_moments(x, mask)
        pooled = torch.cat([mean, floor_sqrt(var)], dim=1)
        endpoints["pooling"] = pooled

        x = self.dense6(pooled)
        endpoints["dense6"] = x
        x = self.bn6(x)
        endpoints["bn6"] = x
        x = relu(x)
        endpoints["relu6"] = x

        mu = self.zs_dense(x)
        endpoints["zs_mu_dense"] = mu
        if not cfg.get("spk_last_layer_no_bn", False):
            mu = self.zs_bn(mu)
            endpoints["zs_mu_bn"] = mu
        if not cfg.get("spk_last_layer_linear", False):
            mu = relu(mu)
            endpoints["zs_mu_relu"] = mu
        return mu

    def _phone_branch(self, x, endpoints):
        relu = _relu(self.config)
        for i in range(self.num_shared, len(self.phone_spec)):
            name = _layer_name("conv" if self.phone_spec[i][0] > 1 else "dense", i, "phn_")
            x = _affine(getattr(self, name), x)
            endpoints[name] = x
            x = getattr(self, "phn_bn%d" % (i + 1))(x)
            endpoints["phn_bn%d" % (i + 1)] = x
            x = relu(x)
            endpoints["phn_relu%d" % (i + 1)] = x
        mu = self.zp_dense(x)
        endpoints["zp_mu_dense"] = mu
        mu = self.zp_bn(mu)
        endpoints["zp_mu_bn"] = mu
        mu = relu(mu)
        endpoints["zp_mu_relu"] = mu
        return mu

    # ------------------------------------------------------------------
    def forward(
        self,
        features: torch.Tensor,        # [B, L+lc+rc, D]
        spk_labels: torch.Tensor,      # [B]
        phn_labels: torch.Tensor,      # [B, L]
        feat_length: torch.Tensor,     # [B]
        phn_mask_idx: Optional[torch.Tensor],  # [B, K], or None = all frames
        step=0,
        spk_margin_override=None,
        aux_enabled: bool = True,
        sample_weight: Optional[torch.Tensor] = None,  # [B] row weight
    ):
        cfg = self.config
        endpoints: Dict[str, torch.Tensor] = {}
        shared = self._shared_prefix(features, endpoints)
        mu_zs = self._speaker_branch(shared, feat_length, endpoints)
        mu_zp = self._phone_branch(shared, endpoints)
        assert mu_zp.shape[1] == phn_labels.shape[1], (
            "phone branch length %d != labels length %d — check phone contexts"
            % (mu_zp.shape[1], phn_labels.shape[1])
        )
        endpoints["mu_zs"] = mu_zs
        endpoints["mu_zp"] = mu_zp
        endpoints["output"] = mu_zs

        spk_loss, spk_ep = self.spk_softmax(
            mu_zs, spk_labels, step, spk_margin_override, sample_weight, aux_enabled)
        endpoints.update({"spk_" + k: v for k, v in spk_ep.items()})

        if phn_mask_idx is None:
            # All-frames phone loss: every frame enters, weighted by its
            # utterance's validity mask (and the row weight, if any).
            b, length = phn_labels.shape
            zp_sub = mu_zp.reshape(b * length, -1)
            lab_sub = phn_labels.reshape(b * length)
            frames = torch.arange(length, device=phn_labels.device)
            fw = (frames[None, :] < feat_length[:, None]).to(torch.float32)
            if sample_weight is not None:
                fw = fw * sample_weight[:, None]
            phn_w = fw.reshape(b * length)
        else:
            # Gather the sampled phone frames: [B, K, D] -> [B*K, D].
            b, k = phn_mask_idx.shape
            idx = phn_mask_idx.long()
            zp_sub = torch.gather(mu_zp, 1, idx[:, :, None].expand(-1, -1, mu_zp.shape[2]))
            zp_sub = zp_sub.reshape(b * k, -1)
            lab_sub = torch.gather(phn_labels, 1, idx).reshape(b * k)
            phn_w = (None if sample_weight is None
                     else torch.repeat_interleave(sample_weight, k))
        endpoints["mu_zp_subset"] = zp_sub
        endpoints["phn_labels_subset"] = lab_sub
        if phn_w is not None:
            endpoints["phn_weight_subset"] = phn_w
        phn_loss, phn_ep = self.phn_softmax(zp_sub, lab_sub, step, None, phn_w, aux_enabled)
        endpoints.update({"phn_" + k2: v for k2, v in phn_ep.items()})

        loss = (float(cfg.get("spk_loss_weight", 1.0)) * spk_loss
                + float(cfg.get("phn_loss_weight", 1.0)) * phn_loss)
        endpoints["spk_loss"] = spk_loss
        endpoints["phn_loss"] = phn_loss
        return loss, endpoints

    def predict_speaker(self, features: torch.Tensor, feat_length: torch.Tensor) -> torch.Tensor:
        """The ``embedding_node`` endpoint (default ``zs_mu_dense``) for
        [B, L+lc+rc, D] inputs."""
        endpoints: Dict[str, torch.Tensor] = {}
        shared = self._shared_prefix(features, endpoints)
        self._speaker_branch(shared, feat_length, endpoints)
        return endpoints[self.config.get("embedding_node", "zs_mu_dense")]

    def predict_phone(self, features: torch.Tensor) -> torch.Tensor:
        """Per-frame phone log-posteriors [B, L, num_phones]: the
        log-softmax of the phone head's logits (the reference's
        "log-output" node, compute_loglike.py:54-105)."""
        endpoints: Dict[str, torch.Tensor] = {}
        shared = self._shared_prefix(features, endpoints)
        mu_zp = self._phone_branch(shared, endpoints)
        b, length, d = mu_zp.shape
        flat = mu_zp.reshape(b * length, d)
        dummy = torch.zeros((b * length,), dtype=torch.int32, device=flat.device)
        _, ep = self.phn_softmax(flat, dummy, 0, None, None, False)
        return torch.log_softmax(ep["logits"], dim=-1).reshape(b, length, -1)
