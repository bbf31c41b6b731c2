"""What the reference networks share: the additive-margin softmax head
(Wang et al. 2018: logits against unit columns, the target's cosine
lowered by m, blended with the plain logits by the annealing weight lambda
= max(lambda_min, base (1 + gamma step)^-power) as the recipe's config sets
it), the L2 term (0.5 * l2 * ||w||^2 of every kernel), momentum SGD
(trace = g + momentum * trace, w -= lr * trace), the glorot-uniform limit,
and the control: with ``control=True`` each convolution's and product's
two operands are rounded to the precision just below the one the
configuration states before it runs, the gradients passing straight
through the rounding: float8 e4m3 under a per-tensor scale (amax / 448)
for ``compute_dtype: bfloat16``, TF32 (10 mantissa bits, as the tensor
cores round their inputs) for float32.

A network is a ``Net`` with ``frames`` (features to frame-level
activations), ``pool`` and ``segment`` (pooled vector to the embedding
endpoints, ``output`` among them) over a dict of float32 parameters under
the port's state-dict names, which is how the benchmark hands the same
weights to both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

VAR_FLOOR = 1e-12


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes through unchanged."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (the nearest float32 with 10 mantissa bits); the
    gradient passes through unchanged."""
    bits = x.detach().to(torch.float32).contiguous().view(torch.int32)
    q = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (q - x).detach()


def lower(cfg: Dict):
    """The control's rounding for a configuration."""
    return _fp8 if cfg.get("compute_dtype", "float32") == "bfloat16" else _tf32


class Net:
    """The parts every network shares; subclasses add ``frames`` and
    ``segment``."""

    def __init__(self, cfg: Dict, p: Dict[str, torch.Tensor], control: bool = False):
        self.cfg = cfg
        self.p = p
        self.q = lower(cfg) if control else (lambda x: x)

    @staticmethod
    def pool(h: torch.Tensor) -> torch.Tensor:
        """Mean || floored standard deviation over time."""
        mean = h.mean(dim=1)
        var = ((h - mean[:, None]) ** 2).mean(dim=1)
        return torch.cat([mean, torch.sqrt(torch.where(var <= VAR_FLOOR, VAR_FLOOR, var))], 1)

    def loss(self, emb: torch.Tensor, labels: torch.Tensor, step: int) -> torch.Tensor:
        cfg = self.cfg
        kernel = self.p["softmax.output_kernel"]
        unit = kernel / torch.linalg.vector_norm(kernel, dim=0, keepdim=True)
        logits = self.q(emb) @ self.q(unit)
        target = logits.gather(1, labels[:, None])[:, 0]
        norm = torch.linalg.vector_norm(emb, dim=1)
        cos = torch.clamp(target / norm, -1 + 1e-12, 1 - 1e-12)
        margin = (cos - float(cfg["amsoftmax_m"])) * norm
        lam = max(float(cfg["amsoftmax_lambda_min"]),
                  float(cfg["amsoftmax_lambda_base"])
                  * (1.0 + float(cfg["amsoftmax_lambda_gamma"]) * step)
                  ** (-float(cfg["amsoftmax_lambda_power"])))
        fa = 1.0 / (1.0 + lam)
        onehot = F.one_hot(labels, logits.shape[1]).to(logits.dtype)
        blended = logits + fa * onehot * (margin - target)[:, None]
        return F.cross_entropy(blended, labels)

    def l2(self) -> torch.Tensor:
        wreg = float(self.cfg.get("weight_l2_regularizer", 0.0))
        out = float(self.cfg.get("output_weight_l2_regularizer", wreg))
        total = 0.0
        for name, t in self.p.items():
            if name == "softmax.output_kernel":
                total = total + 0.5 * out * torch.sum(t * t)
            elif name.endswith(".weight"):
                total = total + 0.5 * wreg * torch.sum(t * t)
        return total


def trainable(spec) -> List[str]:
    """Names of the parameters the optimizer moves (not the BatchNorm
    running statistics)."""
    return [name for name, _, kind in spec if kind not in ("bn_mean", "bn_var")]


def train_steps(net_cls, cfg: Dict, p: Dict[str, torch.Tensor], names: List[str], batches,
                lr: float, control: bool = False):
    """Run momentum SGD over ``batches`` ((features [B, T, dim], labels
    [B]) on one device) from the parameters ``p``. Returns the losses
    (without the L2 term), the first step's gradient of every name in
    ``names`` and the parameters at the end."""
    p = {k: v.clone() for k, v in p.items()}
    momentum = float(cfg["momentum"])
    trace = {k: torch.zeros_like(p[k]) for k in names}
    losses, first = [], None
    for step, (feats, labels) in enumerate(batches):
        leaves = {k: p[k].requires_grad_(True) for k in names}
        net = net_cls(cfg, p, control)
        out = net.segment(net.pool(net.frames(feats)))["output"]
        loss = net.loss(out, labels, step)
        grads = torch.autograd.grad(loss + net.l2(), list(leaves.values()))
        with torch.no_grad():
            for k, g in zip(names, grads):
                trace[k] = g + momentum * trace[k]
                p[k] = p[k].detach() - lr * trace[k]
        if first is None:
            first = {k: g.detach() for k, g in zip(names, grads)}
        losses.append(float(loss.detach()))
    return losses, first, {k: v.detach() for k, v in p.items()}


def glorot_limit(shape) -> float:
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))
